"""The port's sharding plan (``repro_torch.sharding``, ``launch.specs``)
against the reference's on identical inputs: the parameter spec of every
leaf of all ten architectures at full size, the sanitized spec and the
local shard shape on the 16 x 16 and 2 x 16 x 16 production meshes
(the port's from DTensor on a fake process group, in a subprocess; the
reference's from ``NamedSharding.shard_shape`` on a mesh of the one CPU
device repeated), the activation table in both modes, and the cache and
batch specs of every cache leaf at decode_32k and long_500k. Specs are
compared as tuples of axis names, exactly."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from _hypothesis_compat import given, settings, st

from repro.configs import ARCH_NAMES, get_config as ref_config
from repro.configs.shapes import INPUT_SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.launch import specs as RS
from repro.sharding.rules import make_rules as ref_make_rules
from repro.sharding.rules import sanitize_spec as ref_sanitize

from repro_torch.configs import get_config
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs
from repro_torch.launch import specs as S
from repro_torch.sharding.rules import (P, ShardingRules, batch_axes,
                                        make_rules, sanitize_spec)
from repro_torch.tree import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """The two attributes the port's rules read from a ``DeviceMesh``:
    the axis names and the shape (no process group needed)."""

    def __init__(self, shape, names):
        self.mesh = np.zeros(shape)
        self.mesh_dim_names = tuple(names)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), names)


def _ref_path(path) -> str:
    parts = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            parts.append(str(p.key))
        else:
            parts.append(str(getattr(p, "idx", p)))
    return "/".join(parts)


def _ref_leaves(tree):
    return {_ref_path(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tup(spec):
    return tuple(spec)


_REF_PARAMS = {}


def ref_params(arch):
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = _ref_leaves(RS.params_shape(ref_config(arch)))
    return _REF_PARAMS[arch]


# ---------------------------------------------------------------------- #
# parameter specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_spec_every_leaf(arch):
    ref = ref_params(arch)
    port = flatten(S.params_shape(get_config(arch)))
    assert sorted(port) == sorted(ref)
    for mesh_name, (shape, names) in MESHES.items():
        rrules = ref_make_rules(_jax_mesh(shape, names))
        prules = make_rules(FakeMesh(shape, names))
        for path, leaf in ref.items():
            want = rrules.param_spec(path, len(leaf.shape))
            got = prules.param_spec(path, port[path].ndim)
            assert _tup(got) == _tup(want), (mesh_name, path, got, want)


def test_param_spec_rules():
    """The reference's own examples (``test_param_spec_rules``)."""
    rules = make_rules(FakeMesh((1, 1), ("data", "model")))
    assert rules.param_spec("embed/table", 2) == P("model", "data")
    assert rules.param_spec("units/sub0/attn/wq/w", 3) == \
        P(None, "data", "model")
    assert rules.param_spec("units/sub0/attn/wo/w", 3) == \
        P(None, "model", "data")
    assert rules.param_spec("units/sub0/ffn/experts/gate", 4) == \
        P(None, "model", "data", None)
    assert rules.param_spec("ln_f/scale", 1) == P(None)
    assert rules.param_spec("units/mamba/mamba/in_proj/w", 4) == \
        P(None, None, "data", "model")
    assert rules.param_spec("units/mamba/mamba/A_log", 3) == \
        P(None, None, "model")


def test_sanitize_drops_odd_vocab():
    mesh = FakeMesh((4, 4), ("data", "model"))
    spec = sanitize_spec(mesh, (51865, 384), P("model", "data"))
    assert spec[0] is None and spec[1] == "data"


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 4096), st.integers(1, 4096),
       st.sampled_from(sorted(MESHES)))
def test_sanitize_always_divisible(d0, d1, mesh_name):
    """Twin of the reference's property, on the production meshes and a
    two-axis entry: every kept entry divides its dim, and the result is
    the reference's."""
    shape, names = MESHES[mesh_name]
    mesh = FakeMesh(shape, names)
    sizes = dict(zip(names, shape))
    spec = P(batch_axes(mesh), "model")
    out = sanitize_spec(mesh, (d0, d1), spec)
    for dim, axes in zip((d0, d1), out):
        if axes is not None:
            prod = 1
            for a in axes if isinstance(axes, tuple) else (axes,):
                prod *= sizes[a]
            assert dim % prod == 0
    ref = ref_sanitize(_jax_mesh(shape, names), (d0, d1),
                       PartitionSpec(*spec))
    assert _tup(out) == _tup(ref)


# ---------------------------------------------------------------------- #
# sanitized specs and local shard shapes on the production meshes
# ---------------------------------------------------------------------- #
LOCAL_SHAPES = r"""
import json, sys
sys.path[:0] = [{src!r}]
import torch.distributed as dist
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import fake_mesh, fake_world
from repro_torch.sharding.rules import make_rules, sanitize_spec
from repro_torch.tree import flatten
out = {{}}
for label, shape, names in (("16x16", (16, 16), ("data", "model")),
                            ("2x16x16", (2, 16, 16),
                             ("pod", "data", "model"))):
    with fake_world(256 if len(names) == 2 else 512):
        mesh = fake_mesh(shape, names)
        rules = make_rules(mesh)
        for arch in ARCH_NAMES:
            p = S.params_shape(get_config(arch))
            pl = flatten(S.param_shardings(rules, p))
            for path, t in flatten(p).items():
                spec = sanitize_spec(mesh, t.shape,
                                     rules.param_spec(path, t.ndim))
                local, _ = compute_local_shape_and_global_offset(
                    t.shape, mesh, pl[path])
                out[f"{{label}}|{{arch}}|{{path}}"] = [
                    [list(a) if isinstance(a, tuple) else a for a in spec],
                    list(local)]
    assert not dist.is_initialized()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_local_shapes():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-c",
         LOCAL_SHAPES.format(src=os.path.join(ROOT, "src"))],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _from_json(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_sanitized_spec_and_local_shape(arch, mesh_name, port_local_shapes):
    shape, names = MESHES[mesh_name]
    jmesh = _jax_mesh(shape, names)
    rrules = ref_make_rules(jmesh)
    for path, leaf in ref_params(arch).items():
        spec = ref_sanitize(jmesh, leaf.shape,
                            rrules.param_spec(path, len(leaf.shape)))
        want = NamedSharding(jmesh, spec).shard_shape(leaf.shape)
        got_spec, got_local = port_local_shapes[
            f"{mesh_name}|{arch}|{path}"]
        assert _from_json(got_spec) == _tup(spec), (path, got_spec, spec)
        assert tuple(got_local) == tuple(want), (path, got_local, want)


# ---------------------------------------------------------------------- #
# activation table, batch and cache specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_activation_table(mesh_name, seq_shard):
    shape, names = MESHES[mesh_name]
    ref = ref_make_rules(_jax_mesh(shape, names),
                         seq_shard_cache=seq_shard).activation_table()
    got = make_rules(FakeMesh(shape, names),
                     seq_shard_cache=seq_shard).activation_table()
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert _tup(got[name]) == _tup(ref[name]), name


def _cache_leaves_ref(arch, shape_name):
    cfg = ref_config(arch)
    from repro.configs.shapes import shape_applicable
    if shape_applicable(cfg, REF_SHAPES[shape_name]):
        return None
    return _ref_leaves(ref_input_specs(cfg, REF_SHAPES[shape_name])["cache"])


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_and_batch_specs(arch, shape_name):
    ref = _cache_leaves_ref(arch, shape_name)
    if ref is None:
        assert arch == "whisper-tiny" and shape_name == "long_500k"
        return
    port = {k: t for k, t in flatten(input_specs(
        get_config(arch), INPUT_SHAPES[shape_name])["cache"]).items()
        if not isinstance(t, int)}
    assert sorted(port) == sorted(ref)
    seq = shape_name == "long_500k"
    for mesh_name, (shape, names) in MESHES.items():
        jmesh = _jax_mesh(shape, names)
        rrules = ref_make_rules(jmesh, seq_shard_cache=seq)
        prules = make_rules(FakeMesh(shape, names), seq_shard_cache=seq)
        for path, leaf in ref.items():
            nd = len(leaf.shape)
            want = RS.cache_spec(rrules, path, nd, seq_shard=seq)
            got = S.cache_spec(prules, path, port[path].ndim, seq_shard=seq)
            assert _tup(got) == _tup(want), (mesh_name, path, got, want)
            assert _tup(sanitize_spec(prules.mesh, port[path].shape, got)) \
                == _tup(ref_sanitize(jmesh, leaf.shape, want)), path
        for nd in (0, 1, 2, 3):
            assert _tup(S.batch_spec(prules, "tokens", nd)) == _tup(
                RS.batch_spec(rrules, "tokens", nd))


def test_placements_of_a_spec():
    """One tensor dim over two mesh axes: a Shard on each, in mesh
    order; a dim over one axis: a Shard on that mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.rules import placements
    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(mesh, P(None, ("data", "model"))) == (
        Replicate(), Shard(1), Shard(1))
    assert placements(mesh, P(None, None)) == (Replicate(),) * 3


def test_rules_import_starts_no_group():
    import torch.distributed as dist
    assert isinstance(make_rules(FakeMesh((1, 1), ("data", "model"))),
                      ShardingRules)
    assert not dist.is_initialized()
