"""A tiny cell as data, for the CPU tests: a checkout root holding a
``BENCHMARK.json``, a configuration, a traffic mix and limits, of the
dense, vlm or hybrid family at widths a test can hold."""
import json
import os

RUNS = {
    "dense": {"arch": "minicpm-2b", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
              "d_ff": 128, "vocab": 256, "tie_embeddings": True,
              "rope": True, "rope_theta": 10000.0, "norm_eps": 1e-5,
              "qkv_bias": False, "dtype": "bfloat16"},
    "vlm": {"arch": "qwen2-vl-2b", "family": "vlm", "n_layers": 2,
            "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
            "d_ff": 128, "vocab": 256, "tie_embeddings": True, "rope": True,
            "rope_theta": 10000.0, "norm_eps": 1e-5, "qkv_bias": False,
            "mrope_sections": [2, 3, 3], "vision_tokens": 16,
            "dtype": "bfloat16"},
    "hybrid": {"arch": "zamba2-7b", "family": "hybrid", "n_layers": 4,
               "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
               "d_ff": 128, "vocab": 256, "tie_embeddings": False,
               "rope": True, "rope_theta": 10000.0, "norm_eps": 1e-5,
               "qkv_bias": False, "ssm_state": 16, "ssm_heads": 2,
               "ssm_expand": 2, "ssm_conv": 4, "attn_every": 2,
               "dtype": "bfloat16"},
}
OPTIMIZER = {"lr": 0.0003, "weight_decay": 0.1, "b1": 0.9, "b2": 0.95,
             "eps": 1e-08}
# set from the tiny cells' readings on the CPU at eight seeds (the tests'
# among them): sound runs at most 9.5e-5 / 8.3e-4 / 1.2e-3 (loss, grad,
# change; dense and vlm) and 2.0e-4 / 1.1e-2 / 1.0e-2 (hybrid); the fp8
# control 4.6e-4 to 5.2e-4 / 1.3e-2 to 2.4e-2 (dense, vlm) and 1.5e-3 to
# 2.2e-3 / 3.3e-2 to 3.8e-2 (hybrid); half the batch 0.44-0.77 on grad
LIMITS = {
    "dense": {"loss_gap": 3e-4, "grad_gap": 5e-3, "change_gap": 5e-3},
    "vlm": {"loss_gap": 3e-4, "grad_gap": 5e-3, "change_gap": 5e-3},
    "hybrid": {"loss_gap": 8e-4, "grad_gap": 0.02, "change_gap": 0.013},
}


def config(family: str, dtype: str = "bfloat16") -> dict:
    return {"name": f"tiny-{family}", "family": family,
            "run": dict(RUNS[family], dtype=dtype)}


def make_root(tmp, family="dense", co_tenant=None, dtype="bfloat16",
              seq=128, limits=LIMITS) -> str:
    """A checkout root with the one cell ``tiny.t``."""
    root = str(tmp)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "portbench", d), exist_ok=True)
    conf = config(family, dtype)
    jobs = [{"name": "cell", "config": "cell", "batch": 4, "seq": seq,
             "sub_batch": 2}]
    if co_tenant:
        jobs.append({"name": f"tiny-{co_tenant}",
                     "config": config(co_tenant, dtype), "batch": 4,
                     "seq": seq, "sub_batch": 1})

    def dump(obj, *parts):
        with open(os.path.join(root, *parts), "w") as f:
            json.dump(obj, f)
    dump(conf, "portbench", "configs", "tiny.json")
    dump({"jobs": jobs, "batches": 6, "checked_steps": 3,
          "optimizer": OPTIMIZER}, "portbench", "traffic", "t.json")
    fams = [family] + ([co_tenant] if co_tenant else [])
    dump({"limits": {f"tiny-{f}": dict(limits[f]) for f in fams}},
         "portbench", "limits", "tiny.t.json")
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "..", "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "test", "reduced": [],
                         "file": "portbench/configs/tiny.json", "why": "t"}]
    bench["workloads"] = [{"name": "tiny.t", "config": "tiny",
                           "traffic": "t", "chips": 1, "why": "t"}]
    dump(bench, "BENCHMARK.json")
    return root
