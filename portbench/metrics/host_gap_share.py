"""host_gap_share: the share of the window's wall time outside the
device spans of its graph replays (CUDA events around each replay): the
numpy hand-over both ways, the copies in and out, the per-call host work
and the benchmark's loop."""


def read(run):
    spans = run.spans
    if spans is None or spans.replay_s <= 0 or run.window_s <= 0:
        return None
    return 1.0 - spans.replay_s / run.window_s
