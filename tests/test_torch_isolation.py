"""The port stands alone: importing every module of ``repro_torch``,
``chip_smoke``, ``ssd_variants`` and ``flash_bitwise``
loads neither JAX nor the reference package."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import ssd_variants
import flash_bitwise
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
for name in ("kernels.flash_attention", "kernels.flash_decode",
             "kernels.ssd", "models.ssm", "configs.zamba2_7b",
             "launch.serve", "launch.engine", "launch.prefix",
             "core.calibration", "core.simulator", "core.schedulers",
             "launch.calibrate", "launch.replay", "checkpoint.npz",
             "util.retry", "launch.train", "launch.quickstart",
             "models.moe", "configs.glm4_9b", "configs.stablelm_12b",
             "configs.llama3_405b", "configs.granite_moe",
             "configs.llama4_maverick", "models.xlstm",
             "configs.xlstm_1_3b", "configs.whisper_tiny",
             "kernels.autotune", "launch.autotune", "launch.wire",
             "launch.agent", "launch.fleet", "launch.fleet_cli"):
    assert "repro_torch." + name in names, name
"""


def test_port_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(
            root=ROOT, src=os.path.join(ROOT, "src"))],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 48


def test_no_source_of_the_port_names_jax_or_the_reference():
    """A lazy import inside a function would escape the import check."""
    bad = []
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "ssd_variants.py"),
             os.path.join(ROOT, "flash_bitwise.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                words = line.replace(",", " ").split()
                if words[:1] in (["import"], ["from"]) and any(
                        w == "jax" or w.startswith("jax.") or w == "repro"
                        or w.startswith("repro.") for w in words[1:2]):
                    bad.append(f"{path}:{n}: {line.strip()}")
    assert not bad, bad
