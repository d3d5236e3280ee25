"""``batch_fill.serve``: frames returned in the window over the slots of
the batches the server returned in it (batches x batch size), both counted
by the harness; the server pads a short batch with copies."""


def read(job, outcome):
    L = outcome.layer
    slots = L["batches_returned"] * L["batch_size"]
    return 100.0 * L["frames_returned"] / slots if slots else None
