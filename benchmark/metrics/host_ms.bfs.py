"""Host ms a fused frame in the driver's `bfs` stage: the drift-free
window's BFS with its CSR rebuild (`PoseGraph.driftfree_window`), over the
program's traced window."""

from benchmark import window


def read(run):
    return window.reading("host_ms", "bfs")
