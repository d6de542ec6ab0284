"""replay_share: the window's calls that replayed a captured graph, over
its calls, from the context's graph-cache counts (graph_cache.GraphCache
.calls) before and after the window."""


def read(run):
    total = sum(run.graph_calls.values())
    if total == 0:
        return None
    return run.graph_calls.get("replay", 0) / total
