"""The scheduler's host time per ``next_batch`` call (us): the event loop's
own per-hook meter, ``SimResult.hook_ms["next_batch"]`` over
``hook_calls["next_batch"]``.  The decision is the only scheduler time the
loop's clock charges (``charge_scheduler_overhead``).  Nothing when the
program's loop does not meter by hook."""


def read(run):
    ms = getattr(run.sim, "hook_ms", None)
    calls = getattr(run.sim, "hook_calls", None)
    if not ms or not calls or not calls.get("next_batch"):
        return None
    return ms["next_batch"] * 1e3 / calls["next_batch"]
