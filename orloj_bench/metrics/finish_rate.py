"""Counted requests that finished within their SLO, over all counted
requests (%): Orloj's headline metric.  A drop, a late finish, a request
unresolved at the window's end and a failed one are misses."""


def read(run):
    if not run.counted:
        return None
    ok = sum(1 for r in run.counted if r.ok and r.rid not in run.failed)
    return 100.0 * ok / len(run.counted)
