"""Padded slots that hold no prompt token, over all slots the card computed
(%): each batch's (padded batch size × bucket) against its prompts'
lengths."""


def read(run):
    slots = sum(b["k_pad"] * b["bucket"] for b in run.batches)
    used = sum(sum(b["lengths"]) for b in run.batches)
    return 100.0 * (slots - used) / slots if slots else None
