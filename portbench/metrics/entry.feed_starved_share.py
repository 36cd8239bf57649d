"""entry.feed_starved_share: the sum of FilterWait over the sum of Total of
every encode file of the window's recordings, from each report's
`encodewaits` (pipeline/transcode.py: the time the encoder's feed waited
for filtered frames, io/process.py DataPumpThread)."""


def read(run):
    total = wait = 0.0
    for report in run.reports():
        for w in report.get("encodewaits") or []:
            total += w.get("total", 0.0)
            wait += w.get("filter_wait", 0.0)
    return 100.0 * wait / total if total > 0 else None
