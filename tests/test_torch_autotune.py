"""The port's autotuner against the reference's (``tests/test_autotune.py``
on the CPU): the artifact's roundtrip, version refusal and stale or absent
files, and no table used until one is installed; ``shape_key`` and ``seq_bucket`` equal to the reference's; the
routing contract of ``ops._resolve`` (explicit beats the entry, the entry
beats ``DEFAULTS``, a CPU tensor takes the plain version whatever the
table says); the port's own rules (a table of another backend or card is
ignored, a ``backend: "ref"`` entry and decode entries whose splits part
within a (head_dim, dtype) are refused, one split per pair); the sweep
end to end on the CPU at smoke size; and each package's ``load_artifact``
reading the other's file."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as kref
from repro_torch.launch import autotune as launch_autotune
from _torch_threads import one_torch_thread  # noqa: F401

CARD = "NVIDIA H100 80GB HBM3"
CUDA = torch.device("cuda")


def _table(entries, backend="cuda", device_name=CARD,
           version=autotune.AUTOTUNE_VERSION):
    return {"version": version, "created": 0.0,
            "meta": {"backend": backend, "device_name": device_name,
                     "card": None, "smoke": True, "iters": 1},
            "entries": entries}


@pytest.fixture(autouse=True)
def _isolate_table(monkeypatch):
    """Every test starts with no table, names the card ``CARD`` without
    touching CUDA, and leaves no table installed."""
    autotune.set_table(None)
    monkeypatch.setattr(autotune, "_card_name", lambda device: CARD)
    yield
    autotune.set_table(None)


def _entry(**kw):
    return {"backend": "kernel", **kw}


class TestArtifact:
    def test_roundtrip(self, tmp_path):
        key = autotune.shape_key("flash_decode", 100, 64, torch.bfloat16)
        payload = _table({key: _entry(split=128)})
        path = str(tmp_path / "autotune_cuda.json")
        autotune.save_artifact(payload, path)
        assert autotune.load_artifact(path) == payload

    def test_save_refuses_wrong_version(self, tmp_path):
        with pytest.raises(ValueError, match="version"):
            autotune.save_artifact(_table({}, version=99),
                                   str(tmp_path / "t.json"))

    def test_load_rejects_version_mismatch(self, tmp_path):
        path = str(tmp_path / "t.json")
        autotune.save_artifact(_table({}), path)
        payload = json.load(open(path))
        payload["version"] = autotune.AUTOTUNE_VERSION + 1
        json.dump(payload, open(path, "w"))
        with pytest.raises(ValueError, match="version"):
            autotune.load_artifact(path)

    @pytest.mark.parametrize("payload", [
        _table({}, version=0),
        {"version": autotune.AUTOTUNE_VERSION, "meta": {"backend": "cuda"}},
        {"version": autotune.AUTOTUNE_VERSION, "entries": {},
         "meta": {}}])
    def test_table_rejects_version_or_schema(self, payload):
        with pytest.raises(ValueError, match="version|schema"):
            autotune.AutotuneTable(payload)

    def test_absent_artifact_falls_back_gracefully(self, tmp_path):
        autotune.reset_table(str(tmp_path / "does_not_exist.json"))
        assert autotune.get_table() is None
        assert autotune.lookup("flash_decode", 64, 64, torch.bfloat16,
                               CUDA) is None

    def test_stale_artifact_falls_back_gracefully(self, tmp_path):
        path = str(tmp_path / "stale.json")
        json.dump(_table({}, version=autotune.AUTOTUNE_VERSION + 1),
                  open(path, "w"))
        autotune.reset_table(path)
        assert autotune.get_table() is None

    def test_explicit_path_is_read_lazily(self, tmp_path):
        """``reset_table(path)`` installs that file's table; ``None``
        uninstalls it."""
        key = autotune.shape_key("flash_decode", 4096, 64, torch.bfloat16)
        path = autotune.save_artifact(_table({key: _entry(split=512)}),
                                      str(tmp_path / "t.json"))
        autotune.reset_table(path)
        assert autotune.lookup("flash_decode", 4096, 64, torch.bfloat16,
                               CUDA)["split"] == 512
        autotune.set_table(None)          # None disables tuned routing
        assert autotune.lookup("flash_decode", 4096, 64, torch.bfloat16,
                               CUDA) is None

    def test_no_table_is_read_until_one_is_installed(self, tmp_path):
        """A valid table at ``DEFAULT_PATH`` is not used by a fresh
        process until ``reset_table()`` installs it: which routes run
        never depends on which files exist."""
        key = autotune.shape_key("flash_decode", 4096, 64, torch.bfloat16)
        path = autotune.save_artifact(_table({key: _entry(split=512)}),
                                      str(tmp_path / "autotune_cuda.json"))
        code = (
            "import sys, torch\n"
            "from repro_torch.kernels import autotune, ops\n"
            "autotune.DEFAULT_PATH = sys.argv[1]\n"
            "autotune._card_name = lambda device: sys.argv[2]\n"
            "args = ('flash_decode', 4096, 64, torch.bfloat16, "
            "{'split': None}, torch.device('cuda'))\n"
            "before = (autotune.get_table(), ops._resolve(*args))\n"
            "autotune.reset_table()\n"
            "print(before[0] is None, before[1]['split'], "
            "ops._resolve(*args)['split'])\n")
        src = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src")
        out = subprocess.run([sys.executable, "-c", code, path, CARD],
                             capture_output=True, text=True, check=True,
                             env={**os.environ, "PYTHONPATH": src})
        assert out.stdout.split() == ["True", "256", "512"]

    def test_default_path_is_the_ports_own(self):
        assert autotune.DEFAULT_PATH.endswith("autotune_cuda.json")
        assert ref_autotune.DEFAULT_PATH.endswith("autotune.json")
        assert not autotune.DEFAULT_PATH.endswith("/autotune.json")


class TestShapeKey:
    @pytest.mark.parametrize("s", [1, 63, 64, 65, 100, 448, 1024, 1500,
                                   2048, 4097, 8192])
    def test_seq_bucket_equals_reference(self, s):
        assert autotune.seq_bucket(s) == ref_autotune.seq_bucket(s)

    @pytest.mark.parametrize("kind,s,d", [
        ("flash_attention", 448, 64), ("flash_attention", 2048, 160),
        ("flash_decode", 1500, 64), ("flash_decode", 8192, 128),
        ("flash_decode_paged", 16, 112), ("flash_decode_paged", 8, 32),
        ("ssd", 100, 16)])
    @pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                         (torch.bfloat16, jnp.bfloat16)])
    def test_shape_key_equals_reference(self, kind, s, d, tdt, jdt):
        want = ref_autotune.shape_key(kind, s, d, jdt)
        assert autotune.shape_key(kind, s, d, tdt) == want
        assert autotune.shape_key(kind, s, d, autotune.dtype_name(tdt)) \
            == want

    def test_key_normalizes_dtype(self):
        a = autotune.shape_key("ssd", 100, 16, torch.float32)
        b = autotune.shape_key("ssd", 128, 16, np.float32)
        c = autotune.shape_key("ssd", 128, 16, torch.zeros(()).dtype)
        assert a == b == c == "ssd|s128|d16|float32"


class TestTableRules:
    def test_ref_entry_is_refused(self):
        key = autotune.shape_key("flash_decode", 64, 64, torch.bfloat16)
        with pytest.raises(ValueError, match="plain version"):
            autotune.AutotuneTable(_table({key: {"backend": "ref"}}))

    def test_decode_splits_must_agree_within_a_pair(self):
        a = autotune.shape_key("flash_decode", 4096, 64, torch.bfloat16)
        b = autotune.shape_key("flash_decode_paged", 16, 64, torch.bfloat16)
        with pytest.raises(ValueError, match="disagree"):
            autotune.AutotuneTable(_table({a: _entry(split=128),
                                           b: _entry(split=512)}))
        # another head dim or dtype may take another split
        c = autotune.shape_key("flash_decode", 4096, 128, torch.bfloat16)
        d = autotune.shape_key("flash_decode", 4096, 64, torch.float32)
        autotune.AutotuneTable(_table({a: _entry(split=128),
                                       c: _entry(split=512),
                                       d: _entry(split=256)}))

    def test_uncovered_decode_class_takes_its_pairs_split(self):
        """Capacity must not choose the split: a linear class the sweep
        did not time, and a paged one, take the pair's split."""
        key = autotune.shape_key("flash_decode", 4096, 64, torch.bfloat16)
        table = autotune.AutotuneTable(_table({key: _entry(split=512)}))
        for kind, s in (("flash_decode", 128), ("flash_decode", 100000),
                        ("flash_decode_paged", 32)):
            assert table.lookup(kind, s, 64, torch.bfloat16,
                                CUDA) == {"split": 512}
        assert table.lookup("flash_decode", 128, 128, torch.bfloat16,
                            CUDA) is None

    @pytest.mark.parametrize("backend,name,device", [
        ("cpu", CARD, CUDA), ("cuda", "NVIDIA A100-SXM4-80GB", CUDA),
        ("cuda", CARD, torch.device("cpu"))])
    def test_other_backend_card_or_device_is_ignored(self, backend, name,
                                                     device):
        key = autotune.shape_key("flash_decode", 64, 64, torch.bfloat16)
        table = autotune.AutotuneTable(
            _table({key: _entry(split=128)}, backend=backend,
                   device_name=name))
        assert table.lookup("flash_decode", 64, 64, torch.bfloat16,
                            device) is None

    def test_same_card_is_honoured(self):
        key = autotune.shape_key("flash_decode", 64, 64, torch.bfloat16)
        table = autotune.AutotuneTable(_table({key: _entry(split=128)}))
        assert table.lookup("flash_decode", 64, 64, torch.bfloat16,
                            CUDA)["split"] == 128


class TestResolve:
    def _install(self, **entries):
        autotune.set_table(autotune.AutotuneTable(_table(
            {autotune.shape_key(kind, s, d, torch.bfloat16): _entry(**kw)
             for kind, (s, d, kw) in entries.items()})))

    def test_defaults_without_a_table(self):
        assert ops._resolve("flash_decode", 4096, 64, torch.bfloat16,
                            {"split": None}, CUDA) == {"split": 256}
        assert ops._resolve("flash_decode_paged", 16, 160, torch.bfloat16,
                            {"split": None}, CUDA) == {"split": 256}

    def test_entry_beats_defaults(self):
        self._install(flash_decode=(4096, 64, {"split": 512}),
                      flash_decode_paged=(16, 64, {"split": 512}))
        assert ops._resolve("flash_decode", 4096, 64, torch.bfloat16,
                            {"split": None}, CUDA) == {"split": 512}
        # the same bucket: 3000 rounds up to 4096
        assert ops._resolve("flash_decode", 3000, 64, torch.bfloat16,
                            {"split": None}, CUDA) == {"split": 512}
        assert ops._resolve("flash_decode_paged", 16, 64, torch.bfloat16,
                            {"split": None}, CUDA) == {"split": 512}

    def test_explicit_beats_entry(self):
        self._install(flash_decode=(4096, 64, {"split": 512}),
                      flash_decode_paged=(16, 64, {"split": 512}))
        assert ops._resolve("flash_decode", 4096, 64, torch.bfloat16,
                            {"split": 128}, CUDA) == {"split": 128}
        assert ops._resolve("flash_decode_paged", 16, 64, torch.bfloat16,
                            {"split": 256}, CUDA) == {"split": 256}

    def test_lookups_are_kept_per_class(self, monkeypatch):
        """A shape class's answer is computed once per table: the card's
        name is read at the first call only."""
        calls = []
        monkeypatch.setattr(autotune, "_card_name",
                            lambda device: calls.append(device) or CARD)
        self._install(flash_decode=(4096, 64, {"split": 512}))
        for _ in range(3):
            assert ops._resolve("flash_decode", 4096, 64, torch.bfloat16,
                                {"split": None}, CUDA) == {"split": 512}
        assert len(calls) == 1

    def test_cpu_tensor_takes_the_plain_version(self):
        """Whatever the table says, a CPU tensor's entry is DEFAULTS and
        its result the plain version's, bitwise."""
        self._install(flash_decode=(64, 64, {"split": 128}),
                      flash_decode_paged=(16, 64, {"split": 128}))
        cpu = torch.device("cpu")
        assert ops._resolve("flash_decode", 64, 64, torch.bfloat16,
                            {"split": None}, cpu) == {"split": 256}
        gen = torch.Generator().manual_seed(0)
        q = torch.randn((2, 1, 4, 64), generator=gen).bfloat16()
        k, v = (torch.randn((2, 64, 2, 64), generator=gen).bfloat16()
                for _ in range(2))
        lengths = torch.tensor([5, 64])
        got = ops.flash_decode(q, k, v, lengths)
        want = kref.flash_decode_ref(q, k.repeat_interleave(2, 2),
                                     v.repeat_interleave(2, 2), lengths)
        assert torch.equal(got, want)
        pages = torch.arange(8, dtype=torch.int32).reshape(2, 4)
        pool = k.reshape(8, 16, 2, 64), v.reshape(8, 16, 2, 64)
        got_p = ops.flash_decode_paged(q, *pool, pages, lengths)
        assert torch.equal(got_p, kref.flash_decode_paged_ref(
            q, *pool, pages, lengths))

    @pytest.mark.parametrize("split", [0, 513, 1.5, True])
    def test_wrappers_refuse_a_split_out_of_range(self, split):
        q = torch.zeros((1, 1, 2, 64))
        k = torch.zeros((1, 8, 2, 64))
        with pytest.raises(ValueError, match="split"):
            fd.flash_decode(q, k, k, torch.tensor([8]), split=split)


class TestSweep:
    def test_one_split_per_pair_never_slower_than_default(self):
        """The split with the least summed time among those no slower
        than 256 in any class of the pair; the default on a tie."""
        def rec(t128, t256, t512):
            return {"rows": [
                {"backend": "kernel", "split": 128, "t": t128},
                {"backend": "kernel", "split": 256, "t": t256},
                {"backend": "kernel", "split": 512, "t": t512},
                {"backend": "ref", "t": 1.0}]}
        sweep = {
            # d64: 512 wins the sum but loses one class -> 128
            "flash_decode|s4096|d64|bfloat16": rec(0.9, 1.0, 0.1),
            "flash_decode_paged|s16|d64|bfloat16": rec(0.9, 1.0, 1.1),
            # d128: a tie keeps the default
            "flash_decode|s4096|d128|bfloat16": rec(1.0, 1.0, 1.0),
            # d160: 512 everywhere faster
            "flash_decode|s4096|d160|bfloat16": rec(2.0, 1.0, 0.5),
            "flash_decode_paged|s16|d160|bfloat16": rec(2.0, 1.0, 0.9),
        }
        assert autotune.choose_decode_splits(sweep) == {
            (64, "bfloat16"): 128, (128, "bfloat16"): 256,
            (160, "bfloat16"): 512}

    def test_pick_never_chooses_the_plain_version(self):
        rows = [{"backend": "kernel", "split": 128, "t": 2.0},
                {"backend": "kernel", "split": 256, "t": 3.0},
                {"backend": "ref", "t": 0.5},
                {"backend": "library", "t": 0.25}]
        e = autotune._pick(rows, {"split": 256}, "t")
        assert e == {"backend": "kernel", "split": 128, "t_best": 2.0,
                     "t_ref": 0.5, "t_lib": 0.25, "t_default": 3.0,
                     "speedup_vs_default": 1.5}
        fixed = autotune._pick(rows, {"split": 256}, "t",
                               winner={"split": 256})
        assert fixed["split"] == 256 and fixed["speedup_vs_default"] == 1.0

    def test_tiny_sweep_end_to_end(self, tmp_path):
        """A smoke sweep on the CPU (every candidate times the plain
        version) gives a loadable table whose choices are never slower
        than the default, one decode split per pair, and which the card
        never uses (``backend: "cpu"``)."""
        table, bench = autotune.run_autotune(smoke=True, iters=1,
                                             device="cpu")
        assert set(table["entries"]) == set(bench["entries"])
        assert table["meta"]["backend"] == "cpu"
        kinds = {k.split("|")[0] for k in table["entries"]}
        assert kinds == {"flash_attention", "flash_decode",
                         "flash_decode_paged", "ssd"}
        for key, e in table["entries"].items():
            assert e["backend"] == "kernel", key
            assert e["speedup_vs_default"] >= 1.0, (key, e)
            assert e["t_best"] <= e["t_default"]
            assert e["t_ref"] > 0
            assert (e["t_lib"] is None) == key.startswith("ssd"), key
        splits = {e["split"] for k, e in table["entries"].items()
                  if k.startswith("flash_decode")}
        assert len(splits) == 1
        assert bench["decode_splits"] == {"d64|bfloat16": splits.pop()}
        # attention has one form: its entries carry no knob
        attn = table["entries"]["flash_attention|s128|d160|bfloat16"]
        assert {k for k in attn if not k.startswith("t_")} == {
            "backend", "speedup_vs_default"}
        assert attn["speedup_vs_default"] == 1.0
        rows = bench["sweep"]["flash_attention|s128|d64|bfloat16"]["rows"]
        assert [r["backend"] for r in rows] == ["kernel", "ref", "library"]
        path = autotune.save_artifact(table, str(tmp_path / "t.json"))
        loaded = autotune.AutotuneTable(autotune.load_artifact(path))
        assert loaded.lookup("flash_decode", 300, 64, torch.bfloat16,
                             CUDA) is None

    def test_cli_writes_table_and_bench(self, tmp_path, capsys):
        out = str(tmp_path / "autotune_cuda.json")
        assert launch_autotune.main(["--smoke", "--iters", "1", "--device",
                                     "cpu", "--out", out]) == 0
        table = autotune.load_artifact(out)
        bench = json.load(open(tmp_path / launch_autotune.BENCH_NAME))
        assert bench["entries"] == table["entries"]
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == len(table["entries"]) + 1
        assert json.loads(lines[-1])["backend"] == "cpu"


class TestCrossPackage:
    def test_reference_reads_the_ports_file(self, tmp_path):
        table, _ = autotune.run_autotune(smoke=True, iters=1, device="cpu")
        path = autotune.save_artifact(table, str(tmp_path / "port.json"))
        assert ref_autotune.load_artifact(path) == table

    def test_port_reads_the_references_file(self, tmp_path):
        key = ref_autotune.shape_key("flash_decode", 100, 32, jnp.float32)
        payload = {"version": ref_autotune.AUTOTUNE_VERSION, "created": 0.0,
                   "meta": {"backend": "cpu", "interpret": True,
                            "smoke": True, "iters": 1},
                   "entries": {key: {"backend": "kernel", "block_k": 64}}}
        path = ref_autotune.save_artifact(payload,
                                          str(tmp_path / "ref.json"))
        assert autotune.load_artifact(path) == payload
        stale = dict(payload, version=1)
        json.dump(stale, open(path, "w"))
        for load in (autotune.load_artifact, ref_autotune.load_artifact):
            with pytest.raises(ValueError, match="version"):
                load(path)
