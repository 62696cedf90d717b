"""The port's input shapes and dry-run stand-ins (``configs/shapes.py``,
``launch/specs.py``) against the reference's: ``input_specs``,
``shape_applicable`` and ``variant_for_shape`` for all 40 (arch x shape)
pairs by shapes and dtypes (``meta`` tensors here, ShapeDtypeStructs
there; token ids are int64 in the port, int32 in the reference), and
``params_shape``'s shapes, parameter count and ``opt_shape``'s moment
dtype for all ten archs. Nothing is allocated."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config as ref_config
from repro.configs import shapes as RSH
from repro.launch import specs as RS
from repro.models import param_count as ref_param_count

from repro_torch.configs import get_config
from repro_torch.configs import shapes as SH
from repro_torch.launch import specs as S
from repro_torch.models import param_count
from repro_torch.tree import flatten

# dtype names across the packages; the port's token ids are torch's index
# type
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int64: "int32"}


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


def _port_leaves(tree):
    return {k: t for k, t in flatten(tree).items()
            if isinstance(t, torch.Tensor)}


def test_shape_catalogue():
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SH.INPUT_SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in RSH.INPUT_SHAPES.items()}
    assert SH.LONG_CTX_WINDOW == RSH.LONG_CTX_WINDOW


@pytest.mark.parametrize("shape_name", sorted(RSH.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_all_pairs(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_config(arch)
    shape, rshape = SH.INPUT_SHAPES[shape_name], RSH.INPUT_SHAPES[shape_name]
    skip = SH.shape_applicable(cfg, shape)
    assert skip == RSH.shape_applicable(rcfg, rshape)
    assert SH.variant_for_shape(cfg, shape).sliding_window == \
        RSH.variant_for_shape(rcfg, rshape).sliding_window
    if skip:
        assert arch == "whisper-tiny" and shape_name == "long_500k"
        return
    got = _port_leaves(SH.input_specs(cfg, shape))
    want = _ref_leaves(RSH.input_specs(rcfg, rshape))
    # the port's cache holds the encoder rows' count as a host int, not a
    # leaf; the reference keeps it as an array leaf
    want.pop("cache/cross_len", None)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        t = got[key]
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(leaf.shape), key
        assert DTYPES[t.dtype] == str(jnp.dtype(leaf.dtype)), key


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_and_opt_shape(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    p = S.params_shape(cfg)
    rp = RS.params_shape(rcfg)
    got, want = _port_leaves(p), _ref_leaves(rp)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert DTYPES[got[key].dtype] == str(jnp.dtype(leaf.dtype)), key
    assert param_count(p) == ref_param_count(rp)
    o, ro = S.opt_shape(cfg, p), RS.opt_shape(rcfg, rp)
    mdt = {t.dtype for t in _port_leaves(o.m).values()}
    rmdt = {str(jnp.dtype(x.dtype)) for x in jax.tree.leaves(ro.m)}
    assert {DTYPES[d] for d in mdt} == rmdt
    assert S.moment_dtype(p) == (torch.bfloat16 if rmdt == {"bfloat16"}
                                 else torch.float32)


def test_train_accum_steps_and_threshold():
    assert S.TRAIN_ACCUM_STEPS == RS.TRAIN_ACCUM_STEPS
    assert S.BF16_MOMENTS_ABOVE == RS.BF16_MOMENTS_ABOVE
