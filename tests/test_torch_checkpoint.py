"""The port's npz checkpoints (``repro_torch.checkpoint``): twins of the
reference's checkpoint tests (``tests/test_checkpoint_data.py``), and the
two packages reading each other's files bitwise under one CRC."""
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.checkpoint.npz import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.train import OptState as RefOptState
from repro_torch.checkpoint import (CheckpointError, checkpoint_crc,
                                    load_pytree, params_from_numpy, restore,
                                    save, save_pytree)
from repro_torch.configs import get_config
from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
from repro_torch.models import init_params
from repro_torch.train import OptState, adamw_init
from repro_torch.tree import flatten, tree_map
from _torch_threads import one_torch_thread  # noqa: F401


def _cfg(name="minicpm-2b", dtype="float32"):
    return dataclasses.replace(get_config(name).reduced(), dtype=dtype)


def _equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        assert torch.equal(fa[key], fb[key]), key


def _noisy_opt(params, step, seed):
    gen = torch.Generator().manual_seed(seed)

    def rand(t):
        return torch.randn(t.shape, generator=gen, dtype=torch.float32)
    return OptState(step=step, m=tree_map(rand, params),
                    v=tree_map(lambda t: rand(t).abs(), params))


# ===================================================================== #
# Twins of tests/test_checkpoint_data.py
# ===================================================================== #
def test_checkpoint_roundtrip(tmp_path):
    params = init_params(_cfg(), 0, device="cpu")
    opt = _noisy_opt(params, 7, 1)
    path = str(tmp_path / "ck.npz")
    save(path, params=params, opt_state=opt, step=7)
    like_p = tree_map(torch.zeros_like, params)
    like_o = adamw_init(like_p)
    p2, o2, step = restore(path, params_like=like_p, opt_like=like_o)
    assert step == 7 and o2.step == 7
    _equal(p2, params)
    _equal(o2.m, opt.m)
    _equal(o2.v, opt.v)
    # restored in place: the templates' own tensors hold the state
    assert p2["embed"]["table"] is like_p["embed"]["table"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"a": torch.ones(3, 4)})
    like = {"a": torch.zeros(4, 3)}
    with pytest.raises(ValueError):
        load_pytree(path, like)
    assert (like["a"] == 0).all()       # nothing written on failure


def test_load_missing_file_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_pytree(str(tmp_path / "nope.npz"), {"a": torch.ones(2)})


def test_load_corrupted_file_raises_checkpoint_error(tmp_path):
    path = tmp_path / "garbage.npz"
    path.write_bytes(b"this is not an npz archive")
    with pytest.raises(CheckpointError) as ei:
        load_pytree(str(path), {"a": torch.ones(2)})
    assert ei.value.path == str(path)
    assert str(path) in str(ei.value)


def test_load_truncated_file_raises_checkpoint_error(tmp_path):
    path = tmp_path / "trunc.npz"
    save_pytree(str(path), {"a": torch.arange(4096, dtype=torch.float32)})
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(CheckpointError):
        load_pytree(str(path), {"a": torch.zeros(4096)})


def test_bit_rot_detected_by_content_crc(tmp_path):
    path = tmp_path / "rot.npz"
    tree = {"a": torch.arange(64, dtype=torch.float32),
            "b": {"c": torch.ones(4, 4)}}
    save_pytree(str(path), tree)
    with np.load(str(path)) as data:
        members = {k: data[k].copy() for k in data.files}
    members["a"][17] += 1.0
    np.savez(str(path), **members)
    with pytest.raises(CheckpointError, match="CRC mismatch"):
        load_pytree(str(path), tree_map(torch.zeros_like, tree))


def test_checkpoint_crc_is_a_content_digest(tmp_path):
    tree = {"a": torch.arange(8, dtype=torch.float32), "step": 3}
    p1, p2, p3 = (str(tmp_path / n) for n in ("x.npz", "y.npz", "z.npz"))
    save_pytree(p1, tree)
    save_pytree(p2, tree)
    save_pytree(p3, {**tree, "step": 4})
    c1, c2, c3 = map(checkpoint_crc, (p1, p2, p3))
    assert c1 == c2 and c1 is not None
    assert c3 != c1
    out = load_pytree(p1, {"a": torch.zeros(8), "step": 0})
    assert (out["a"] == torch.arange(8)).all() and out["step"] == 3


def test_legacy_checkpoint_without_crc_loads_unchecked(tmp_path):
    path = tmp_path / "legacy.npz"
    np.savez(str(path), a=np.arange(4, dtype=np.float32))
    assert checkpoint_crc(str(path)) is None
    out = load_pytree(str(path), {"a": torch.zeros(4)})
    assert (out["a"] == torch.arange(4)).all()


def test_save_pytree_is_atomic_no_tmp_left(tmp_path):
    path = tmp_path / "ck.npz"
    save_pytree(str(path), {"a": torch.ones(3)})
    save_pytree(str(path), {"a": torch.zeros(3)})    # overwrite in place
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
    out = load_pytree(str(path), {"a": torch.ones(3)})
    assert (out["a"] == 0).all()


# ===================================================================== #
# The two packages read each other's files
# ===================================================================== #
def _ref_state(name, dtype, seed=0, step=5):
    """Reference params (its own init) and an optimizer state with
    nonzero moments; numpy copies of both under the reference's keys."""
    cfg = dataclasses.replace(ref_get_config(name).reduced(), dtype=dtype)
    params = ref_init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat = ref_flatten(params)
    m = {k: rng.standard_normal(a.shape).astype(np.float32)
         for k, a in flat.items()}
    v = {k: np.abs(rng.standard_normal(a.shape)).astype(np.float32)
         for k, a in flat.items()}
    treedef = jax.tree.structure(params)
    keys = list(flat)

    def tree(d):
        return jax.tree.unflatten(treedef, [jnp.asarray(d[k]) for k in keys])
    opt = RefOptState(step=jnp.asarray(step, jnp.int32), m=tree(m),
                      v=tree(v))
    return params, opt, flat, m, v


def _port_state(flat, m, v, step):
    return (params_from_numpy(flat, device="cpu"),
            OptState(step=step, m=params_from_numpy(m, device="cpu"),
                     v=params_from_numpy(v, device="cpu")))


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return [(n, zf.read(n)) for n in zf.namelist()]


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-vl-2b"])
def test_f32_checkpoints_cross_bitwise_with_one_crc(tmp_path, name):
    r_params, r_opt, flat, m, v = _ref_state(name, "float32")
    p_params, p_opt = _port_state(flat, m, v, 5)
    rp, pp = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_ckpt.save(rp, params=r_params, opt_state=r_opt, step=9)
    save(pp, params=p_params, opt_state=p_opt, step=9)
    assert checkpoint_crc(pp) == ref_ckpt.checkpoint_crc(rp) is not None
    # same members in the same order, each byte for byte
    assert _members(pp) == _members(rp)

    # the reference's file into the port
    like_p = tree_map(torch.zeros_like, p_params)
    got_p, got_o, step = restore(rp, params_like=like_p,
                                 opt_like=adamw_init(like_p))
    assert step == 9 and got_o.step == 5
    _equal(got_p, p_params)
    _equal(got_o.m, p_opt.m)
    _equal(got_o.v, p_opt.v)

    # the port's file into the reference
    zeros = jax.tree.map(jnp.zeros_like, r_params)
    rz_opt = RefOptState(step=jnp.zeros((), jnp.int32),
                         m=jax.tree.map(jnp.zeros_like, r_opt.m),
                         v=jax.tree.map(jnp.zeros_like, r_opt.v))
    got_rp, got_ro, rstep = ref_ckpt.restore(pp, params_like=zeros,
                                             opt_like=rz_opt)
    assert rstep == 9 and int(got_ro.step) == 5
    for a, b in zip(jax.tree.leaves((r_params, r_opt)),
                    jax.tree.leaves((got_rp, got_ro))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_checkpoint_crc_equals_the_reference_and_reloads(tmp_path):
    r_params, r_opt, flat, m, v = _ref_state("minicpm-2b", "bfloat16")
    p_params, p_opt = _port_state(flat, m, v, 5)
    assert flatten(p_params)["embed/table"].dtype == torch.bfloat16
    rp, pp = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_ckpt.save(rp, params=r_params, opt_state=r_opt, step=9)
    save(pp, params=p_params, opt_state=p_opt, step=9)
    assert checkpoint_crc(pp) == ref_ckpt.checkpoint_crc(rp)
    assert _members(pp) == _members(rp)
    with np.load(pp) as data:
        assert data["params/embed/table"].dtype == np.dtype("V2")
    # the port reloads its own bf16 file, and the reference's, bitwise
    for path in (pp, rp):
        like_p = tree_map(torch.zeros_like, p_params)
        got_p, got_o, step = restore(path, params_like=like_p,
                                     opt_like=adamw_init(like_p))
        assert step == 9 and got_o.step == 5
        _equal(got_p, p_params)
        _equal(got_o.m, p_opt.m)


def test_executor_checkpoint_has_the_reference_keys(tmp_path):
    spec = JobSpec(_cfg(), batch=2, seq=16)
    with ScheduleExecutor(device="cpu", checkpoint_dir=str(tmp_path),
                          checkpoint_every=1) as ex:
        ex.submit("a", spec, 1)
        ex.start("a")
        ex.step_group(["a"])
        pkeys = sorted(flatten(ex.runs["a"].params))
    with np.load(str(tmp_path / "a.npz")) as data:
        files = {k: data[k] for k in data.files}
    want = ({"opt/.step", "step", "__crc32__"}
            | {f"{p}/{k}" for p in ("opt/.m", "opt/.v", "params")
               for k in pkeys})
    assert set(files) == want
    for key in ("opt/.step", "step"):
        assert files[key].dtype == np.int32 and files[key].shape == ()
        assert int(files[key]) == 1
    # the reference's own save of the same architecture: the same keys
    r_params, r_opt, _, _, _ = _ref_state("minicpm-2b", "float32")
    rp = str(tmp_path / "ref.npz")
    ref_ckpt.save(rp, params=r_params, opt_state=r_opt, step=1)
    with np.load(rp) as data:
        assert set(data.files) == want
