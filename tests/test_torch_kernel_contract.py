"""The one vmap rule of the port's kernel wrappers (`ops/cuda/kernel.py`,
`_Launch`), driven on the CPU: under `torch.func.vmap` it hands a fake
launch every tensor operand with the stream axis first and contiguous, an
operand that vmap does not batch repeated for each stream, the non-tensor
arguments and None operands as they are, and gives each tensor output the
stream axis; an operand written in place must carry the stream axis.  On
the card the rule fires for batched CUDA tensors only (`kernel.dispatch`),
so no other CPU test reaches it.  This file imports no JAX."""

from typing import NamedTuple

import pytest
import torch

from densesurfelmapping_tpu_torch.ops.cuda import kernel

B, SHAPE = 3, (4, 5)


class Cfg(NamedTuple):
    scale: float = 2.0


def _operand(seed, batched=True):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(((B,) if batched else ()) + SHAPE, generator=g)


def _b(seed, dim=0):
    """An operand that vmap batches along `dim`."""
    return _operand(seed).movedim(0, dim).contiguous()


def _u(seed):
    """An operand that vmap does not batch."""
    return _operand(seed, batched=False)


def _sum(ts):
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def _fake(seen, n_out, none_at=None, inplace=None):
    """A launch that records its arguments and returns n_out outputs,
    output k being (k + 1) times the sum of its tensor operands (None at
    `none_at`; one tensor, not a tuple, for n_out 1).  With `inplace` it
    adds the other tensor operands into that operand and returns it."""
    def launch(*args):
        seen.append([(a.clone(), a.is_contiguous(),
                      torch._C._functorch.is_batchedtensor(a))
                     if isinstance(a, torch.Tensor) else a for a in args])
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        if inplace is not None:
            return args[inplace].add_(_sum([t for t in ts
                                            if t is not args[inplace]]))
        outs = tuple(None if k == none_at else (k + 1) * _sum(ts)
                     for k in range(n_out))
        return outs[0] if n_out == 1 else outs
    return launch


# (the call's arguments, vmap's in_dims, outputs, the None output, the
# operand written in place)
CASES = {
    "leading_config": (lambda: (Cfg(), _b(0), _b(1)), (None, 0, 0), 2,
                       None, None),
    "trailing_options": (lambda: (_b(0), (0, 1, -1), 1.0, "y"),
                         (0, None, None, None), 1, None, None),
    "none_operand": (lambda: (_b(0), None, 3, True), (0, None, None, None),
                     3, 1, None),
    "one_output": (lambda: (_b(0), _b(1)), (0, 0), 1, None, None),
    "two_outputs": (lambda: (_b(0), _b(1)), (0, 0), 2, None, None),
    "six_outputs": (lambda: (_b(0), _b(1), _b(2)), (0, 0, 0), 6, None, None),
    "unbatched_expanded": (lambda: (_b(0), _u(1)), (0, None), 2, None, None),
    "inplace_out": (lambda: (_b(0), _b(1)), (0, 0), 1, None, 1),
    "inplace_out_strided": (lambda: (_b(0), _b(1, 1)), (0, 1), 1, None, 1),
    "inplace_out_unbatched": (lambda: (_b(0), _u(1)), (0, None), 1, None,
                              1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_vmap_rule_covers_every_shape_of_call(case):
    make, in_dims, n_out, none_at, inplace = CASES[case]
    args = make()
    before = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    seen = []
    launch = _fake(seen, n_out, none_at, inplace)
    out_dims = (0 if n_out == 1
                else tuple(None if k == none_at else 0 for k in range(n_out)))
    call = torch.func.vmap(
        lambda *a: kernel._Launch.apply(launch, inplace, *a),
        in_dims=in_dims, out_dims=out_dims)
    if case == "inplace_out_unbatched":
        with pytest.raises(ValueError, match="must carry the stream axis"):
            call(*args)
        assert seen == []
        return
    got = call(*args)

    # one launch; each tensor operand unbatched, contiguous, the stream
    # axis first (an unbatched one repeated); the rest as they were
    assert len(seen) == 1
    tensors = []
    for a, b, d in zip(seen[0], before, in_dims):
        if not isinstance(b, torch.Tensor):
            assert a == b
            continue
        t, contiguous, batched = a
        want = b.expand(B, *b.shape) if d is None else b.movedim(d, 0)
        assert contiguous and not batched
        assert t.shape == (B,) + SHAPE and torch.equal(t, want)
        tensors.append(want)

    # every tensor output carries the stream axis first
    outs = got if isinstance(got, tuple) else (got,)
    assert len(outs) == n_out
    for k, o in enumerate(outs):
        if k == none_at:
            assert o is None
            continue
        assert o.shape == (B,) + SHAPE
        assert torch.equal(o, (k + 1) * _sum(tensors))
    if inplace is not None:
        # the operand written in place holds the sum, in its own layout
        d = in_dims[inplace]
        assert torch.equal(args[inplace].movedim(d, 0), _sum(tensors))
