"""Share (%) of the traced slice's slot steps in which the slot held a live
row (``LauraServingSession.stats``: live steps over slot steps). None where
the slice ran no decode step."""


def read(run):
    slot_steps = run.work.get("slot_steps")
    return 100.0 * run.work["live_steps"] / slot_steps if slot_steps else None
