"""Host ms a batch takes in the program's train iterator (``MusicDataset``),
from the benchmark's span around each ``next`` in the window."""


def read(ctx):
    if not ctx.data_s:
        return None
    return 1e3 * sum(ctx.data_s) / len(ctx.data_s)
