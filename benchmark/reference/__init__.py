"""The plain reference that decides a run's `correct`.

Frozen copies of the port's plain PyTorch path (the functions its CPU tests
hold to the JAX package), taken when the benchmark was written and never
edited with the program: SLIC (`superpixel.py`, the twins of B1-B3), the
plane fit (`normals.py`), fusion, append and compaction (`fusion.py`), the
loop warp (`warp.py`), the census SGM matcher with the twins of B5 and B6
(`stereo.py`, `sgm.py`, `depthfilter.py`).  Nothing here imports the
program, and no kernel runs: `step.py` composes the frame step from these
functions on whatever device its tensors are on.
"""
