"""server.overlap_share: the share of the window in which at least two
server jobs are past their phase gates at once (each job from its start to
its end, less the time it waited at PhaseScheduler.wait), from the
harness's spans of each job. None outside a server cell."""

from pb.probes import clip


def read(run):
    if run.cell.traffic["entry"] != "server":
        return None
    active = {}
    for s in run.spans_of("recording"):
        active.setdefault(s.job, []).append((s.t0, s.t1))
    waits = {}
    for s in run.spans_of("gate"):
        waits.setdefault(s.job, []).append((s.t0, s.t1))
    edges = []
    for job, spans in active.items():
        for a, b in clip(spans, run.t0, run.t1):
            edges += [(a, 1), (b, -1)]
        for a, b in clip(waits.get(job, []), run.t0, run.t1):
            edges += [(a, -1), (b, 1)]
    if not edges:
        return None
    both, level, last = 0.0, 0, run.t0
    for t, d in sorted(edges):
        if level >= 2:
            both += t - last
        level += d
        last = t
    return 100.0 * both / (run.t1 - run.t0)
