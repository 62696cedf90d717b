"""The port's ``DecodeEngine`` on the CPU: the twins of the reference's
engine tests (``test_serve_engine.py``, ``test_paged_engine.py``,
``test_prefix_cache.py``, ``test_serve_degradation.py``), pinned inside
the port. Token identities are bitwise: engine == solo generation,
paged == dense, prefix-shared == private. The port's copy of the prefix
trie is held against the reference's on the same operations.

Reduced minicpm-2b in f32 throughout; on the CPU every attention core
takes its plain version, as the device routes it."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.prefix import PrefixTrie as JaxTrie
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.prefix import PrefixTrie
from repro_torch.models import (init_cache, init_paged_cache, init_params,
                                prefill, prefill_extend)
from repro_torch.models.attention import attention_decode, attention_init
from _torch_threads import one_torch_thread  # noqa: F401


def _cfg(name="minicpm-2b", **kw):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **kw)


_PARAMS = {}


def _params(cfg):
    if cfg.name not in _PARAMS:
        _PARAMS[cfg.name] = init_params(cfg, 0, device="cpu")
    return _PARAMS[cfg.name]


def _solo(cfg, params, prompt, n, max_len):
    toks = serve.generate(cfg, params, torch.as_tensor(prompt)[None, :],
                          max_new_tokens=n, max_len=max_len)
    return toks[0].tolist()


def _drain(eng, prompts, tokens=8):
    rids = [eng.submit(p, tokens) for p in prompts]
    eng.run()
    return [eng.outputs[r] for r in rids]


PROMPT_LENS = (5, 8, 3, 8, 6)
NEWS = [7, 4, 9, 6, 5]


# ====================================================================== #
# dense and paged engines
# ====================================================================== #
@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-vl-2b"])
def test_slot_reuse_never_leaks_and_paged_equals_dense(name):
    """More requests than slots: every request's tokens equal its solo
    generation, through the dense and the paged engine alike."""
    cfg = _cfg(name)
    params = _params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in PROMPT_LENS]
    outs = []
    for paged in (False, True):
        eng = DecodeEngine(cfg, params, n_slots=2, max_len=32, segment=4,
                           paged=paged, page_size=8, n_pages=8, debug=True)
        rids = [eng.submit(p, n) for p, n in zip(prompts, NEWS)]
        out = eng.run()
        assert eng.stats["admitted"] == len(prompts)
        assert not eng.active.any() and not eng.queue
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]
    for prompt, n, got in zip(prompts, NEWS, outs[0]):
        assert got == _solo(cfg, params, prompt, n, 32)


def test_admission_between_segments():
    cfg = _cfg()
    rng = np.random.default_rng(1)
    eng = DecodeEngine(cfg, _params(cfg), n_slots=2, max_len=32, segment=4)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab, (4,)), 4)
    eng.step_segment()                  # admits 2 of 3, queue holds 1
    assert eng.stats["admitted"] == 2 and len(eng.queue) == 1
    eng.run()
    assert eng.stats["admitted"] == 3
    assert all(len(v) == 4 for v in eng.outputs.values())


def test_submit_refuses_a_request_past_max_len():
    cfg = _cfg()
    eng = DecodeEngine(cfg, _params(cfg), n_slots=1, max_len=16, segment=4)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(10, np.int64), 5)     # 10 + 2 x 4 rows > 16


def test_dense_idle_slot_overflow_write_drops():
    """The dense engine never resets a freed slot's index: an idle slot
    keeps stepping past ``max_len``. Its writes must drop (JAX drops an
    out-of-bounds scatter; PyTorch would raise on the CPU and fault on
    the card), and the busy slot's tokens stay those of its solo run."""
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.default_rng(2)
    short = rng.integers(0, cfg.vocab, (12,))     # idle from segment 2
    long_ = rng.integers(0, cfg.vocab, (4,))       # 4 + 7 x 4 rows = 32
    eng = DecodeEngine(cfg, params, n_slots=2, max_len=32, segment=4)
    r_short = eng.submit(short, 4)
    r_long = eng.submit(long_, 28)
    before = None
    while eng.queue or eng.active.any():
        if before is None and int(eng.cache["index"][0]) >= 32:
            before = eng.cache["units"]["k"][:, 0].clone()
        eng.step_segment()
    assert before is not None and int(eng.cache["index"][0]) > 32
    # every write of the idle slot since its index passed the cache dropped
    assert torch.equal(eng.cache["units"]["k"][:, 0], before)
    assert eng.outputs[r_short] == _solo(cfg, params, short, 4, 32)
    assert eng.outputs[r_long] == _solo(cfg, params, long_, 28, 32)


def test_scatter_rows_drops_rows_past_the_cache():
    from repro_torch.models.attention import _scatter_rows
    cache = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3, 1)
    keep = cache.clone()
    new = torch.full((2, 1, 3, 1), -1.0)
    _scatter_rows(cache, new, torch.tensor([2, 4]))
    assert torch.equal(cache[0, 2], new[0, 0])
    keep[0, 2] = new[0, 0]
    assert torch.equal(cache, keep)               # row 4 of 4: dropped


# ====================================================================== #
# paged layout
# ====================================================================== #
def _paged_setup(b=3, max_len=32, ps=8, n_pg=16):
    rng = np.random.default_rng(1)
    d_model, nh, nkv, hd = 64, 4, 2, 16
    gen = torch.Generator().manual_seed(0)
    p = attention_init(gen, d_model, nh, nkv, hd, n_units=1,
                       dtype=torch.float32, device="cpu")
    p = {k: {"w": v["w"][0]} for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((b, 1, d_model), np.float32))
    idx = torch.tensor([3, 11, 30])
    p_tab = max_len // ps
    dense = {k: torch.from_numpy(rng.standard_normal((b, max_len, nkv, hd),
                                                     np.float32))
             for k in ("k", "v")}
    pages = torch.full((b, p_tab), -1, dtype=torch.int32)
    pool = {k: torch.zeros((n_pg + 1, ps, nkv, hd)) for k in ("k", "v")}
    free = list(range(n_pg))
    for bi in range(b):
        for pi in range(-(-(int(idx[bi]) + 1) // ps)):
            pg = free.pop()
            pages[bi, pi] = pg
            for k in ("k", "v"):
                pool[k][pg] = dense[k][bi, pi * ps:(pi + 1) * ps]
    kw = dict(n_heads=nh, n_kv_heads=nkv, head_dim=hd)
    return p, x, idx, dense, pool, pages, kw


def test_paged_decode_bitwise_equals_dense_and_writes_the_owning_page():
    p, x, idx, dense, pool, pages, kw = _paged_setup()
    out_d, cache_d = attention_decode(p, x, None, None, dense, idx, **kw)
    out_p, cache_p = attention_decode(p, x, None, None, pool, idx,
                                      pages=pages, **kw)
    assert torch.equal(out_d, out_p)
    ps = pool["k"].shape[1]
    for bi, i in enumerate(idx.tolist()):
        pg = int(pages[bi, i // ps])
        assert torch.equal(cache_p["k"][pg, i % ps], cache_d["k"][bi, i])


def test_unassigned_page_write_drops():
    """An example whose table has no page for its index (an idle engine
    slot) must not touch any real pool page, the last one included (a
    wrapping index -1 would hit it); its write lands in the scratch
    page."""
    p, x, idx, _, pool, pages, kw = _paged_setup()
    before = {k: v.clone() for k, v in pool.items()}
    blank = torch.full_like(pages, -1)
    attention_decode(p, x, None, None, pool, idx, pages=blank, **kw)
    for k in ("k", "v"):
        assert torch.equal(pool[k][:-1], before[k][:-1])
        assert not torch.equal(pool[k][-1], before[k][-1])  # scratch


def test_init_paged_cache_contract():
    cfg = _cfg()
    with pytest.raises(ValueError, match="multiple"):
        init_paged_cache(cfg, 2, 33, page_size=8, n_pages=8, device="cpu")
    with pytest.raises(ValueError, match="linear"):
        init_paged_cache(_cfg(sliding_window=8), 2, 32, page_size=8,
                         n_pages=8, device="cpu")
    cache = init_paged_cache(cfg, 2, 32, page_size=8, n_pages=8,
                             device="cpu")
    assert cache["pages"].shape == (2, 4)
    assert (cache["pages"] == -1).all()
    assert cache["units"]["k"].shape == (cfg.n_units, 8 + 1, 8,
                                         cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="linear"):
        DecodeEngine(_cfg(sliding_window=8), _params(cfg), paged=True)


def test_growth_and_reclaim_on_slot_reuse():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    eng = DecodeEngine(cfg, _params(cfg), n_slots=2, max_len=32, segment=4,
                       paged=True, page_size=8, n_pages=8)
    # 5 prompt + 8 decode rows = 13 -> reserve 2 pages, assign 1
    eng.submit(rng.integers(0, cfg.vocab, (5,)), 8)
    eng._admit()
    assert eng._slot_npages[0] == 1 and eng._slot_reserve[0] == 2
    assert eng._avail_pages == 8 - 2
    eng._grow()                     # rows [0, 5 + 4): second page
    assert eng._slot_npages[0] == 2
    assert len(eng._free_pages) == 8 - 2
    while eng.queue or eng.active.any():
        eng.step_segment()
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab, (6,)), 7)
    eng.run()
    assert sorted(eng._free_pages) == list(range(8))
    assert eng._avail_pages == 8
    assert (eng._pages_np == -1).all()
    assert (eng._slot_npages == 0).all() and (eng._slot_reserve == 0).all()
    assert eng.stats["peak_pages_in_use"] > 0


def test_admission_defers_until_pages_free():
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.default_rng(0)
    eng = DecodeEngine(cfg, params, n_slots=4, max_len=32, segment=4,
                       paged=True, page_size=8, n_pages=4)
    prompts = [rng.integers(0, cfg.vocab, (5,)) for _ in range(4)]
    rids = [eng.submit(p, 7) for p in prompts]
    out = eng.run()
    assert eng.stats["admission_deferred_pages"] > 0
    assert eng.stats["peak_active_slots"] == 2     # 4 pages / 2 per request
    for rid, prompt in zip(rids, prompts):
        assert out[rid] == _solo(cfg, params, prompt, 7, 32)


def test_more_slots_than_dense_at_equal_memory():
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (8,)) for _ in range(8)]
    dense = DecodeEngine(cfg, params, n_slots=2, max_len=64, segment=8)
    paged = DecodeEngine(cfg, params, n_slots=8, max_len=64, segment=8,
                         paged=True, page_size=8, n_pages=16)
    assert _drain(dense, prompts) == _drain(paged, prompts)
    assert dense.stats["peak_active_slots"] == 2
    assert paged.stats["peak_active_slots"] == 8
    assert paged.stats["segments"] < dense.stats["segments"]


# ====================================================================== #
# prefix sharing
# ====================================================================== #
def _share_engine(cfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("segment", 8)
    kw.setdefault("page_size", 8)
    kw.setdefault("n_pages", 32)
    kw.setdefault("debug", True)
    return DecodeEngine(cfg, _params(cfg), paged=True, **kw)


@pytest.mark.parametrize("plen,start", [(12, 7), (9, 2), (16, 8),
                                        (13, 11)])
def test_prefill_extend_matches_full_prefill(plen, start):
    """Suffix rows of the prefill, recomputed from a cache whose prefix
    rows are filled, against the full prefill's rows.

    Bitwise in the reference; not in the port on the CPU, where a matmul
    row can depend on how many rows the call has: with a transposed right
    operand (the tied head ``x @ table.T``, and ``q k^T``) PyTorch's CPU
    matmul sums another way for up to 10 rows (the head) or 2 rows
    (``q k^T``). So the logits are held to 1e-5 after dividing by
    max(1, max|full|) (f32 sums in another order), and the K/V rows are
    bitwise wherever the suffix has at least 3 rows, else to 1e-5. The
    engine's token identities (prefix-shared == private) hold bitwise in
    the tests below."""
    cfg = _cfg()
    params = _params(cfg)
    toks = torch.as_tensor(np.random.default_rng(plen).integers(
        0, cfg.vocab, (1, plen)))
    lg_full, c_full = prefill(cfg, params, init_cache(cfg, 1, 32,
                                                      device="cpu"),
                              toks)
    c_pre = init_cache(cfg, 1, 32, device="cpu")
    for key in ("k", "v"):
        c_pre["units"][key][:, :, :start] = c_full["units"][key][:, :,
                                                                 :start]
    lg_ext, c_ext = prefill_extend(cfg, params, c_pre, toks[:, start:],
                                   start=start)
    scale = max(1.0, float(lg_full.abs().max()))
    torch.testing.assert_close(lg_ext / scale, lg_full[:, start:] / scale,
                               rtol=1e-5, atol=1e-5)
    assert int(c_ext["index"]) == plen
    for key in ("k", "v"):
        got = c_ext["units"][key][:, :, :plen]
        want = c_full["units"][key][:, :, :plen]
        if plen - start >= 3:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prefix_share_requires_paged():
    cfg = _cfg()
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(cfg, _params(cfg), prefix_share=True)


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-vl-2b"])
def test_prefix_shared_equals_private_and_solo(name):
    """Shared-prefix tokens == private-pages tokens == solo generation;
    the 20-token shared prefix is 2.5 pages, so the boundary page forks
    copy-on-write."""
    cfg = _cfg(name)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 20)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 6)])
               for _ in range(5)]
    base = _drain(_share_engine(cfg, prefix_share=False), prompts)
    eng = _share_engine(cfg, prefix_share=True)
    assert _drain(eng, prompts) == base
    assert eng.stats["prefix_hits"] >= 4
    assert eng.stats["prefill_tokens_saved"] > 0
    assert eng.stats["cow_forks"] >= 1
    assert base[1] == _solo(cfg, _params(cfg), prompts[1], 8, 64)


def test_prefix_capacity_at_equal_memory():
    cfg = _cfg()
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab, 24)         # 3 full pages
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 8)])
               for _ in range(12)]
    kw = dict(n_slots=12, n_pages=20)
    private = _share_engine(cfg, prefix_share=False, **kw)
    base = _drain(private, prompts)
    eng = _share_engine(cfg, prefix_share=True, **kw)
    assert _drain(eng, prompts) == base
    assert private.stats["peak_active_slots"] == 4   # 20 // 5
    assert eng.stats["peak_active_slots"] >= 8


def test_drain_returns_all_pages_below_watermark():
    cfg = _cfg()
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 20)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 6)])
               for _ in range(5)]
    eng = _share_engine(cfg, prefix_share=True, retain_pages=0)
    _drain(eng, prompts)
    assert sorted(eng._free_pages) == list(range(eng.n_pages))
    assert eng._trie.page_count() == 0
    assert (eng._page_refs == 0).all() and eng._committed == 0
    assert (eng._pages_np == -1).all()
    assert eng.stats["prefix_evictions"] > 0
    eng._check_invariants()


def test_retention_watermark_and_default_retention():
    cfg = _cfg()
    rng = np.random.default_rng(4)
    eng = _share_engine(cfg, prefix_share=True, retain_pages=4)
    _drain(eng, [rng.integers(0, cfg.vocab, 16) for _ in range(6)])
    assert eng._trie.evictable_pages(eng._page_refs) <= 4
    assert eng.stats["prefix_evictions"] > 0
    # the default watermark (the whole pool) keeps prefixes across drains
    shared = rng.integers(0, cfg.vocab, 16)
    eng = _share_engine(cfg, prefix_share=True)
    _drain(eng, [np.concatenate([shared, rng.integers(0, cfg.vocab, 8)])])
    assert eng._trie.page_count() > 0
    _drain(eng, [np.concatenate([shared, rng.integers(0, cfg.vocab, 8)])])
    assert eng.stats["prefix_hits"] == 1


def test_debug_invariants_catch_sentinel_corruption():
    cfg = _cfg()
    eng = _share_engine(cfg, prefix_share=True)
    eng.submit(np.arange(8) % cfg.vocab, 16)
    eng.step_segment()                 # debug mode audited this step
    assert eng.active.any()
    slot = int(np.argmax(eng.active))
    keep = eng._pages_np[slot, 0]
    eng._pages_np[slot, 0] = -1
    with pytest.raises(AssertionError, match="sentinel"):
        eng._check_invariants()
    eng._pages_np[slot, 0] = keep
    eng._pages_np[slot, 7] = 0
    with pytest.raises(AssertionError, match="past npages"):
        eng._check_invariants()


def test_prefix_trie_copy_behaves_like_the_reference():
    """The same inserts, matches and evictions on the port's copy of the
    trie and the reference's give the same answers."""
    rng = np.random.default_rng(5)
    ours, theirs = PrefixTrie(4), JaxTrie(4)
    refs = np.ones(64, np.int32)
    stems = [list(rng.integers(0, 6, 12)) for _ in range(3)]
    for step in range(60):
        stem = stems[rng.integers(0, 3)]
        prompt = stem[:rng.integers(1, 12)] + list(rng.integers(0, 6, 3))
        op = rng.integers(0, 4)
        if op == 0:
            pages = list(rng.integers(0, 64, 5))
            assert ours.insert(prompt, pages) == theirs.insert(prompt, pages)
        elif op == 1:
            assert ours.match(prompt) == theirs.match(prompt)
        elif op == 2:
            assert ours.evict_lru(refs) == theirs.evict_lru(refs)
        else:
            assert (ours.evictable_pages(refs)
                    == theirs.evictable_pages(refs))
        assert ours.page_count() == theirs.page_count()


# ====================================================================== #
# deadlines and brown-out
# ====================================================================== #
class ManualClock:
    def __init__(self, dt=0.0):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        now = self.t
        self.t += self.dt
        return now

    def advance(self, d):
        self.t += d


def _small_engine(clock=None, **kw):
    cfg = _cfg()
    kw.setdefault("n_slots", 1)
    if clock is not None:
        kw["clock"] = clock
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab, (4,))
               for i in range(4)]
    return DecodeEngine(cfg, _params(cfg), max_len=32, segment=4,
                        **kw), prompts


def test_degraded_knobs_off_are_token_identical():
    plain, prompts = _small_engine(n_slots=2)
    clocked, _ = _small_engine(ManualClock(), n_slots=2, brownout_depth=0)
    assert _drain(plain, prompts[:3]) == _drain(clocked, prompts[:3])
    assert clocked.shed == {} and clocked.stats["deadline_miss"] == 0


def test_queued_request_past_deadline_never_admits():
    clock = ManualClock()
    eng, prompts = _small_engine(clock)
    r0 = eng.submit(prompts[0], 8)
    r1 = eng.submit(prompts[1], 8, deadline=5.0)
    eng.step_segment()
    clock.advance(10.0)
    out = eng.run()
    assert eng.shed == {r1: "deadline"} and out[r1] == []
    assert len(out[r0]) == 8
    assert eng.stats["shed_deadline"] == 1 and eng.retry_after[r1] >= 0.0


def test_active_slot_past_deadline_frees_and_keeps_partial():
    clock = ManualClock()
    eng, prompts = _small_engine(clock)
    r0 = eng.submit(prompts[0], 12, deadline=5.0)
    eng.step_segment()                  # 4 of 12 tokens
    clock.advance(10.0)
    eng.step_segment()                  # the shed pre-pass fires
    assert not eng.active.any() and eng.shed == {r0: "deadline"}
    assert len(eng.outputs[r0]) == 4
    assert eng.slot_rid[0] == -1 and eng.slot_deadline[0] is None
    assert eng.retry_after[r0] > 0.0


def test_completed_but_late_counts_deadline_miss():
    eng, prompts = _small_engine(ManualClock(dt=0.3))
    r0 = eng.submit(prompts[0], 4, deadline=0.5)
    eng.step_segment()
    assert len(eng.outputs[r0]) == 4
    assert eng.stats["deadline_miss"] == 1 and r0 not in eng.shed


def test_brownout_sheds_lowest_priority_then_youngest():
    clock = ManualClock()
    eng, prompts = _small_engine(clock, brownout_depth=1)
    r0 = eng.submit(prompts[0], 8)
    eng.step_segment()
    clock.advance(1.0)
    r1 = eng.submit(prompts[1], 8, priority=1)
    clock.advance(1.0)
    r2 = eng.submit(prompts[2], 8, priority=0)
    clock.advance(1.0)
    r3 = eng.submit(prompts[3], 8, priority=1)
    out = eng.run()
    assert eng.shed == {r2: "brownout", r3: "brownout"}
    assert eng.stats["shed_brownout"] == 2
    assert len(out[r0]) == len(out[r1]) == 8


def test_brownout_depth_zero_disables_shedding():
    eng, prompts = _small_engine(brownout_depth=0)
    assert all(len(o) == 4 for o in _drain(eng, prompts, 4))
    assert eng.shed == {}


def test_brownout_evicts_prefixes_before_shedding():
    cfg = _cfg()
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, 24)

    def mk():
        return np.concatenate([shared, rng.integers(0, cfg.vocab, 8)])
    eng = _share_engine(cfg, prefix_share=True, n_slots=8, n_pages=20,
                        brownout_depth=1)
    _drain(eng, [mk()])                 # cold cache: seed the trie
    assert eng._trie.page_count() > 0
    rids = [eng.submit(mk(), 8) for _ in range(8)]
    eng.run()
    assert eng.stats["brownout_prefix_evictions"] > 0
    served = [r for r in rids if r not in eng.shed]
    assert all(len(eng.outputs[r]) == 8 for r in served)
    assert eng.stats["shed_brownout"] == len(eng.shed)
    assert len(eng.shed) < len(rids) - eng.brownout_depth
    assert len(served) >= 4
