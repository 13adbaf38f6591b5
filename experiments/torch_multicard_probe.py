"""Probe: how can a CUDA graph join work on several cards?

    python3 experiments/torch_multicard_probe.py     (2 or more CUDA cards)

Prints the torch/CUDA versions, each card's name and power limit, the
peer-access matrix and `nvidia-smi topo -m`, then tries two designs on
toy work (an elementwise stage on every card, a max gathered to the
first card, the result sent back and added in place):

  (a) one capture that spans the cards: the capture stream on card 0
      forks to a stream on each other card (an event recorded on the
      capture stream, waited on there), each card's allocations go to a
      `torch.cuda.MemPool` of its own (`use_mem_pool`), and every fork
      joins the capture stream before the capture ends;
  (b) one graph per card, ordered by external event nodes
      (`torch.cuda.Event(external=True)`) recorded in one card's graph
      and waited on in the next card's graph (local work only).

Each design's replays are held to an eager run of the same work
(`torch.equal`); after the first replay, eager allocations on every card
try to take the graph's memory (they must not).  One line per result;
the last line is a JSON summary.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback

import torch


def smi(*args: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def work(xs, home):
    """The toy mesh program over per-card inputs xs (updated in place):
    returns the gathered max on the home card."""
    ys = [(x * 2 + 1).sin() for x in xs]
    acc = ys[0]
    for y in ys[1:]:
        acc = torch.maximum(acc, y.to(home, non_blocking=True))
    # a non-contiguous cross-card read too
    acc = acc + ys[-1].view(256, -1).t().contiguous().view(-1).to(home)[0]
    for x in xs:
        x.add_(acc.to(x.device, non_blocking=True))
    return acc.sum()


def design_a(devs, n_rep: int) -> dict:
    home = devs[0]
    pools = {}
    for d in devs:
        with torch.cuda.device(d):
            pools[d] = torch.cuda.MemPool()
    torch.manual_seed(0)
    base = [torch.randn(1 << 16, device=d) for d in devs]
    xs = [b.clone() for b in base]
    ref = [b.clone() for b in base]
    work([b.clone() for b in base], home)       # warm-up: p2p, kernels
    for d in devs:
        torch.cuda.synchronize(d)
    g = torch.cuda.CUDAGraph()
    cs = torch.cuda.Stream(home)
    with torch.cuda.device(home):
        with torch.cuda.graph(g, pool=pools[home].id, stream=cs,
                              capture_error_mode="thread_local"):
            with contextlib.ExitStack() as st:
                lanes = []
                for d in devs[1:]:
                    st.enter_context(torch.cuda.use_mem_pool(pools[d], d))
                    lane = torch.cuda.Stream(d)
                    lane.wait_stream(cs)
                    lanes.append(lane)
                    st.enter_context(torch.cuda.stream(lane))
                st.enter_context(torch.cuda.device(home))
                out = work(xs, home)
            for lane in lanes:
                cs.wait_stream(lane)
    res = {"captured": True}
    outs, refs = [], []
    for i in range(n_rep):
        with torch.cuda.device(home):
            main = torch.cuda.current_stream(home)
            for d in devs[1:]:
                main.wait_stream(torch.cuda.current_stream(d))
            g.replay()
            for d in devs[1:]:
                torch.cuda.current_stream(d).wait_stream(main)
        outs.append(out.clone())
        refs.append(work(ref, home).clone())
        if i == 0:
            # eager allocations on every card must not take graph memory
            junk = [torch.full((1 << 22,), 7.0, device=d) for d in devs]
            del junk
    for d in devs:
        torch.cuda.synchronize(d)
    res["equal"] = all(torch.equal(a, b) for a, b in zip(outs, refs)) and \
        all(torch.equal(a, b) for a, b in zip(xs, ref))
    # time: replays against the eager program
    for name, fn in (("replay", g.replay), ("eager", lambda: work(ref, home))):
        for d in devs:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        for d in devs:
            torch.cuda.synchronize(d)
        res[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    res["pool_mib"] = {
        str(d): sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                    if tuple(s.get("segment_pool_id", ())) == tuple(p.id))
        / 2**20 for d, p in pools.items()}
    return res


def design_b(devs) -> dict:
    """One graph per card: card k's graph waits on card k-1's external
    event node, adds 1 to its own tensor and records its own event.  A
    cross-card copy inside such a graph is not tried: PyTorch issues it
    on the source card's current stream and records an event on the
    destination card's, so it needs (a)'s cross-card streams."""
    xs = [torch.zeros(1024, device=d) for d in devs]
    evs = [torch.cuda.Event(external=True) for _ in devs]
    graphs = []
    for k, d in enumerate(devs):
        with torch.cuda.device(d):
            g = torch.cuda.CUDAGraph()
            # a capture stream on this card (torch.cuda.graph's default
            # one is created once, on whichever card was current)
            with torch.cuda.graph(g, stream=torch.cuda.Stream(d),
                                  capture_error_mode="thread_local"):
                cur = torch.cuda.current_stream(d)
                if k:
                    cur.wait_event(evs[k - 1])
                xs[k].add_(1)
                evs[k].record(cur)
            graphs.append(g)
    for d, g in zip(devs, graphs):
        with torch.cuda.device(d):
            g.replay()
    for d in devs:
        torch.cuda.synchronize(d)
    return {"captured": True,
            "sums": [float(x.sum()) for x in xs]}


def main() -> int:
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    n = torch.cuda.device_count()
    print(smi("--query-gpu=name,power.limit", "--format=csv,noheader"))
    print(smi("topo", "-m"))
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]
    print(f"peer access: {peer}", flush=True)
    if n < 2:
        print("the probe needs 2 or more cards", flush=True)
        return 1
    devs = [torch.device("cuda", i) for i in range(n)]
    summary = {"cards": n, "peer": peer}
    for name, fn in (("a", lambda: design_a(devs, 4)),
                     ("b", lambda: design_b(devs))):
        try:
            summary[name] = fn()
        except Exception as e:       # the probe reports every failure
            summary[name] = {"captured": False,
                             "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        print(f"design {name}: {summary[name]}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
