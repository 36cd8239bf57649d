"""parse.decode_wait_share: the time the passes waited on the decoder's
prefetch queue over the time of those passes (the CM pass, the filter
analysis where it decodes, the output pass where it decodes). Each such
pass's span sums its waits in the attribute `input_wait_s`; a pass with
part of its time outside the window counts its waits in proportion."""

from pb.program_trace import inside, traces


def read(run):
    wait = passes = 0.0
    for tr in traces(run):
        for s in tr["spans"]:
            waited = (s.get("attrs") or {}).get("input_wait_s")
            if waited is None or s["t1"] is None or s["t1"] <= s["t0"]:
                continue
            t = inside(run, s)
            wait += waited * t / (s["t1"] - s["t0"])
            passes += t
    return 100.0 * wait / passes if passes > 0 else None
