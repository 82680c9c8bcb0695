"""encode_Marcs_per_s: arcs encoded by every ``encode`` call completed in
the window, over the whole window, in millions a second (host clock)."""


def read(run):
    if run.op != "encode" or run.window_s <= 0:
        return None
    return run.units / run.window_s / 1e6
