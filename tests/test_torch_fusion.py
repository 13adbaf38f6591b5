"""The port's fusion ops against the JAX package's on a bank made from numpy
with a seed: fuse_surfels (update_times / last_update / fused seeds exact,
positions and normals within 1e-5), append_new and compact_bank (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.core.state import SurfelBank as JBank
from densesurfelmapping_tpu.core.state import pad_frame
from densesurfelmapping_tpu.ops import fusion as JF
from densesurfelmapping_tpu.ops import normals as JN
from densesurfelmapping_tpu.ops import superpixel as JS
from densesurfelmapping_tpu.pipeline.inactive_pool import FIELDS
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core.state import (SuperpixelState,
                                                     bank_from_numpy,
                                                     bank_to_numpy)
from densesurfelmapping_tpu_torch.ops import fusion as TF

from test_driver import tiny_config, render_plane

torch.set_num_threads(1)

CAP = 1024


def _seed_state(ref, pose, noise_seed):
    img, dep = render_plane(ref, pose, noise=0.01, seed=noise_seed)
    pi, pd = pad_frame(ref, img, dep)

    def f(i, d):
        seeds, asg = JS.run_slic(ref, i, d, use_pallas=False)
        seeds, _ = JN.compute_seed_planes(ref, seeds, asg, d)
        return seeds, asg

    seeds, asg = jax.tree_util.tree_map(
        np.asarray, jax.jit(f)(jnp.asarray(pi), jnp.asarray(pd)))
    return seeds, asg, pd


def _bank_fields(seeds, pose, rng):
    """A bank made from the frame's seeds: surfels near the seed planes,
    with random age/weights, dead rows and out-of-window owners."""
    S = seeds.x.size
    pos = seeds.pos.reshape(S, 3) @ pose[:3, :3].T + pose[:3, 3]
    nrm = seeds.norm.reshape(S, 3) @ pose[:3, :3].T
    keep = np.any(seeds.norm.reshape(S, 3) != 0, axis=-1)
    pos, nrm = pos[keep], nrm[keep]
    n = len(pos)
    pos = pos + rng.normal(0, 0.02, pos.shape)
    pos = np.concatenate([pos, rng.uniform(-2, 2, (40, 3)) + [0, 0, 4]])
    nrm = np.concatenate([nrm, rng.normal(size=(40, 3))])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    m = len(pos)
    ut = rng.integers(0, 8, m).astype(np.int32)
    ut[:n // 2] = np.maximum(ut[:n // 2], 1)
    return dict(position=pos.astype(np.float32),
                normal=nrm.astype(np.float32),
                color=rng.uniform(0, 255, m).astype(np.float32),
                size=rng.uniform(0.01, 0.2, m).astype(np.float32),
                weight=rng.uniform(0.01, 2.0, m).astype(np.float32),
                update_times=ut,
                last_update=rng.integers(-1, 6, m).astype(np.int32))


def _jbank(fields, n):
    bank = JBank.empty(CAP)
    upd = {}
    for k, arr in bank.field_arrays():
        host = np.array(arr)
        host[:n] = fields[k]
        upd[k] = jnp.asarray(host)
    return bank.replace(count=jnp.int32(n), **upd)


def _tstate(s) -> SuperpixelState:
    return SuperpixelState(**{k: torch.from_numpy(np.array(getattr(s, k)))
                              for k in SuperpixelState.__dataclass_fields__})


@pytest.fixture(scope="module")
def case():
    ref = tiny_config(max_keyframes=8)
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3], pose[2, 3] = 0.15, 0.1
    seeds0, _, _ = _seed_state(ref, np.eye(4), 1)
    seeds, asg, depth = _seed_state(ref, pose, 2)
    rng = np.random.default_rng(0)
    fields = _bank_fields(seeds0, np.eye(4), rng)
    n = len(fields["color"])
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    frame_index = 7

    jfuse = jax.jit(lambda b, s, a, d, p, m: JF.fuse_surfels(
        ref, b, s, a, d, p, jnp.int32(frame_index), pose_mask=m))
    jseeds = jax.tree_util.tree_map(jnp.asarray, seeds)
    jb, jfused = jfuse(_jbank(fields, n), jseeds, jnp.asarray(asg),
                       jnp.asarray(depth), jnp.asarray(pose),
                       jnp.asarray(mask))
    jseeds = jseeds.replace(fused=jfused)
    new_f, new_m = JF.extract_new_surfels(ref, jseeds, jfused,
                                          jnp.asarray(pose),
                                          jnp.int32(frame_index))
    ja, jstats = JF.append_new(jb, new_f, new_m)
    jc = JF.compact_bank(ja)
    want = [{k: np.array(getattr(b, k))[:int(b.count)] for k in FIELDS}
            for b in (jb, ja, jc)]
    return dict(cfg=tcfg.SurfelMapConfig.from_json(ref.to_json()),
                fields=fields, n=n, seeds=seeds, asg=np.array(asg),
                depth=depth,
                pose=pose, mask=mask, frame_index=frame_index,
                want=want, fused=np.array(jfused),
                new_fields={k: np.array(v) for k, v in new_f.items()},
                new_mask=np.array(new_m),
                stats={k: int(v) for k, v in jstats.items()})


def test_fuse_surfels_matches_jax(case):
    c = case
    bank = bank_from_numpy(c["fields"], c["n"], "cpu", CAP)
    fused = TF.fuse_surfels(
        c["cfg"], bank, _tstate(c["seeds"]), torch.from_numpy(c["asg"]),
        torch.from_numpy(c["depth"]), torch.from_numpy(c["pose"]),
        torch.tensor(c["frame_index"], dtype=torch.int32),
        pose_mask=torch.from_numpy(c["mask"]))
    got, want = bank_to_numpy(bank), c["want"][0]
    # the case exercises fusions, kills and frozen rows
    fused_rows = got["update_times"] > c["fields"]["update_times"]
    killed = (got["update_times"] == 0) & (c["fields"]["update_times"] > 0)
    assert fused_rows.sum() > 10 and killed.sum() > 0
    for k in ("update_times", "last_update"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("position", "normal", "color", "size", "weight"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(fused.numpy(), c["fused"])
    assert c["fused"].any()


def test_extract_new_surfels_matches_jax(case):
    c = case
    seeds = _tstate(c["seeds"]).replace(fused=torch.from_numpy(c["fused"]))
    fields, mask = TF.extract_new_surfels(
        c["cfg"], seeds, seeds.fused, torch.from_numpy(c["pose"]),
        torch.tensor(c["frame_index"], dtype=torch.int32))
    np.testing.assert_array_equal(mask.numpy(), c["new_mask"])
    for k, v in c["new_fields"].items():
        np.testing.assert_allclose(fields[k].numpy(), v, atol=1e-5,
                                   err_msg=k)


def test_append_and_compact_match_jax_exactly(case):
    """From the same bank and candidates, append_new and compact_bank give
    the JAX package's rows bit for bit."""
    c = case
    after_fuse = c["want"][0]
    bank = bank_from_numpy(after_fuse, len(after_fuse["color"]), "cpu", CAP)
    stats = TF.append_new(
        bank, {k: torch.from_numpy(v) for k, v in c["new_fields"].items()},
        torch.from_numpy(c["new_mask"]))
    assert {k: int(v) for k, v in stats.items()} == c["stats"]
    assert c["stats"]["n_new"] > 0
    appended = bank_to_numpy(bank)
    TF.compact_bank(bank)
    for got, want in zip((appended, bank_to_numpy(bank)), c["want"][1:]):
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_append_full_bank_drops():
    """With no room for a full slab the append is skipped and reported."""
    cfg = tcfg.SurfelMapConfig.from_json(tiny_config().to_json())
    S = cfg.num_seeds
    fields = {k: np.zeros((S + 3,) + ((3,) if k in ("position", "normal")
                                      else ()),
                          np.int32 if k in ("update_times", "last_update")
                          else np.float32) for k in FIELDS}
    fields["update_times"][:] = 1
    bank = bank_from_numpy(fields, S + 3, "cpu", 2 * S)
    new = {k: torch.from_numpy(v[:S]) + 1 for k, v in fields.items()}
    mask = torch.arange(S) % 2 == 0
    stats = TF.append_new(bank, new, mask)
    assert int(stats["n_new"]) == 0
    assert int(stats["n_dropped"]) == int(mask.sum())
    assert int(bank.count) == S + 3
