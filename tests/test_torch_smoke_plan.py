"""What ``chip_smoke.py`` still covers, checked on the CPU: the seven
kernels of its ``kernels`` line, every phase run once, every parity case
of phase ``parity``, and ``launch.train``'s reduced depth, whose
checkpoint must fit the room the smoke asks for. The smoke itself needs
an H100; these read its tables and its source."""
import ast
import dataclasses
import inspect
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "flash_decode",
           "flash_decode_paged", "ssd_fwd", "ssd_bwd")
# phase parity's cases (each call times the iterations of the literal
# loops around it); none may go
PARITY_CASES = {"parity_case": 22, "suffix_case": 6, "decode_case": 11,
                "decode_invariance_case": 5, "ring_case": 1,
                "ssd_case": 3, "ssd_state_case": 3, "rect_case": 6}
PHASES = ("build", "parity", "solo", "pair", "calibrate", "replay",
          "policies", "recovery", "train", "profile", "hybrid", "accum",
          "serve", "engine", "autotune", "hybrid_serve", "families",
          "xlstm_whisper", "fleet", "sharded")


def test_replaces_and_sources_name_the_seven_kernels():
    assert tuple(chip_smoke.REPLACES) == KERNELS
    assert tuple(chip_smoke.SOURCES) == KERNELS


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_source_is_in_its_library(kernel):
    """The file the ``kernels`` line names holds the kernel's code, and is
    one of the sources its library is built from."""
    path = chip_smoke.SOURCES[kernel]
    assert os.path.isfile(os.path.join(ROOT, path)), path
    libs = [name for name, (sources, _) in build.LIBRARIES.items()
            if os.path.basename(path) in sources]
    assert len(libs) == 1, (path, libs)
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    names = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
             "flash_bwd_dkdv": "flash_bwd_dkdv_",
             "flash_decode": "flash_decode_split_kernel",
             "flash_decode_paged": "flash_decode_split_kernel",
             "ssd_fwd": "ssd_fwd_chunk_kernel",
             "ssd_bwd": "ssd_bwd_chunk_kernel"}
    assert "__global__" in text and names[kernel] in text


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_replaced_line_is_a_tpu_kernel_body(kernel):
    path, line = chip_smoke.REPLACES[kernel].split(":")
    with open(os.path.join(ROOT, path)) as f:
        text = f.read().splitlines()[int(line) - 1]
    assert text.startswith("def _") and "kernel" in text, text


def _calls(fn, names) -> list:
    """The calls in ``fn``'s source of the functions named ``names``, in
    source order."""
    tree = ast.parse(inspect.getsource(fn))
    return sorted((node for node in ast.walk(tree)
                   if isinstance(node, ast.Call)
                   and getattr(node.func, "id", "") in names),
                  key=lambda node: (node.lineno, node.col_offset))


def _phase_calls():
    return [node.args[0].id[len("phase_"):]
            for node in _calls(chip_smoke.main, ("run",))
            if node.args and isinstance(node.args[0], ast.Name)]


def test_main_runs_every_phase_once_in_order():
    """No phase is skipped, run twice or run under a condition: ``main``
    runs each ``phase_*`` of the script once, in the documented order,
    with no option or variable that chooses."""
    defined = {n[len("phase_"):] for n in dir(chip_smoke)
               if n.startswith("phase_")}
    calls = _phase_calls()
    assert sorted(calls) == sorted(defined) and len(calls) == len(PHASES)
    assert tuple(calls) == PHASES
    body = inspect.getsource(chip_smoke.main)
    assert "environ" not in body and "argv" not in body
    for node in ast.walk(ast.parse(body)):
        if isinstance(node, ast.If):
            assert not any(
                isinstance(c, ast.Call) and getattr(c.func, "id", "") == "run"
                for c in ast.walk(node)), "a phase runs under a condition"


def _case_counts(fn) -> dict:
    """Calls of each case function in ``fn``'s body, each counted once
    for every iteration of the literal ``for`` loops around it."""
    counts = {}

    def visit(node, times):
        if isinstance(node, ast.For) and isinstance(node.iter,
                                                    (ast.Tuple, ast.List)):
            times *= len(node.iter.elts)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in PARITY_CASES:
            counts[node.func.id] = counts.get(node.func.id, 0) + times
        for child in ast.iter_child_nodes(node):
            visit(child, times)
    visit(ast.parse(inspect.getsource(fn)), 1)
    return counts


def test_parity_phase_keeps_every_case():
    assert _case_counts(chip_smoke.phase_parity) == PARITY_CASES


# each case's timed calls, in source order: (helper, iterations)
TIMED = {"parity_case": [("cuda_time", 10), ("cuda_time", 10),
                         ("cuda_time", 10), ("cuda_time", 3)],
         "decode_case": [("cuda_time", 20), ("host_us", 20),
                         ("cuda_time", 5), ("cuda_time", 20)]}


@pytest.mark.parametrize("case", sorted(TIMED))
def test_timing_helpers_keep_their_iterations(case):
    """PERF.md's kernel table reads ``cuda_time`` and ``host_us`` as the
    parity and decode cases call them: the same method, iterations and
    warm-up."""
    for fn in (chip_smoke.cuda_time, chip_smoke.host_us):
        assert inspect.signature(fn).parameters["warmup"].default == 1
    got = [(node.func.id, next(k.value.value for k in node.keywords
                                if k.arg == "iters"))
           for node in _calls(getattr(chip_smoke, case),
                              ("cuda_time", "host_us"))]
    assert got == TIMED[case]


def test_train_depth_checkpoint_fits_the_room_asked_for():
    """``launch.train``'s runs in phases train and sharded: minicpm-2b at
    ``TRAIN_LAYERS`` layers and full width; their checkpoint, reckoned at
    10 bytes a parameter (bf16 parameters, two f32 moments), fits under
    ``TRAIN_CKPT_BYTES``, which is what ``_checkpoint_dir`` asks for."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import init_params, param_count
    args = train.build_argparser().parse_args(chip_smoke.TRAIN_ARGS)
    full = get_config(args.arch)
    with chip_smoke._train_depth() as config:
        cfg = train.get_config(args.arch)
        assert config(args.arch) == cfg
    assert train.get_config is get_config
    assert cfg.n_layers == chip_smoke.TRAIN_LAYERS < full.n_layers
    assert dataclasses.replace(cfg, n_layers=full.n_layers,
                               name=full.name) == full
    reckoned = 10 * param_count(init_params(cfg, 0, device="meta"))
    assert reckoned <= chip_smoke.TRAIN_CKPT_BYTES
    full_bytes = 10 * param_count(init_params(full, 0, device="meta"))
    assert chip_smoke.TRAIN_CKPT_BYTES < full_bytes / 3


def test_train_depth_reaches_the_distributed_run():
    """Phase sharded's run takes the same cut as phase train's: both call
    ``train.run`` inside ``_train_depth``."""
    for fn in (chip_smoke.phase_train, chip_smoke.phase_sharded):
        tree = ast.parse(inspect.getsource(fn))
        withs = [node for node in ast.walk(tree) if isinstance(node, ast.With)
                 and any(getattr(getattr(i.context_expr, "func", None), "id",
                                 "") == "_train_depth" for i in node.items)]
        runs = [node for w in withs for node in ast.walk(w)
                if isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "run"]
        assert len(runs) == 1, fn.__name__


def _trace():
    """A hand-built trace: host ops (one nested in another) with kernels
    beneath them, a kernel named twice, one launched outside any op."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import EventList, FunctionEvent
    events = []

    def event(name, start, end, device_type, parent=None):
        e = FunctionEvent(len(events), name, 0, start, end, stack=[],
                          use_device="cuda", device_type=device_type)
        events.append(e)
        if parent is not None and device_type == DeviceType.CUDA:
            parent.append_kernel(name, 0, end - start)
        elif parent is not None:
            parent.append_cpu_child(e)
            e.set_cpu_parent(parent)
        return e

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    outer = event("aten::einsum", 0, 100, cpu)
    inner = event("aten::bmm", 10, 90, cpu, outer)
    event("gemm_a", 20, 50, cuda, inner)
    event("elementwise", 50, 53, cuda, outer)
    again = event("aten::einsum", 200, 300, cpu)
    event("gemm_a", 210, 260.5, cuda, again)
    event("gemm_b", 300, 301.25, cuda)
    trace = EventList(events, use_device="cuda")
    trace._tree_built = True          # the parents were set above
    return trace


def test_op_device_times_are_key_averages_sums():
    """A host op's device time is what ``key_averages()`` gives it: the
    kernels beneath it, nested ops' included, over every call."""
    trace = _trace()
    ops = ("aten::einsum", "aten::bmm", "aten::add")
    by_op = chip_smoke._op_device_us(trace, ops)
    avg = trace.key_averages()
    assert by_op == {op: sum(e.device_time_total for e in avg
                             if e.key == op) for op in ops}
    assert by_op == {"aten::einsum": 83.5, "aten::bmm": 30.0,
                     "aten::add": 0.0}
    assert chip_smoke._op_device_us((), ()) == {}


def test_trace_totals_are_key_averages_sums():
    """The raw trace's totals a key are the profiler's own, bit for bit and
    in its order: each event named, filtered, timed and sorted as the
    profiler parses it, then summed as ``key_averages()`` sums. Checked on
    the host's events of a CPU profile (no card here) against the parsed
    events before the profiler's event tree is built: the tree then merges
    a host op into a parent of the same name, which no kernel has."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import EventList
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            y = torch.relu(x @ x).sum()
        with torch.autograd.profiler.record_function("twice"):
            (x + y).mean()
    got = chip_smoke._trace_totals(prof, DeviceType.CPU)
    parsed = EventList(prof.profiler._parse_kineto_results(
        prof.profiler.kineto_results), use_device=None)
    parsed._tree_built = True            # as parsed: no merge of nodes
    want = {e.key: [e.cpu_time_total, e.count] for e in parsed.key_averages()
            if e.device_type == DeviceType.CPU}
    assert got == want and list(got) == list(want)
    assert got["aten::mm"][1] == 3 and "twice" in got
    assert chip_smoke._trace_totals(prof, DeviceType.CUDA) == {}


def test_trace_totals_leave_out_the_device_copies_of_host_spans():
    """A ``record_function`` span that launched kernels appears on the
    device's timeline too, as a user annotation over them: no device
    work, so no key of the device's totals (the host's span stays)."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def event(name, device, start, end, note=False):
        return SimpleNamespace(
            name=lambda: name, device_type=lambda: device,
            start_ns=lambda: start, end_ns=lambda: end,
            is_async=lambda: False, start_thread_id=lambda: 1,
            end_thread_id=lambda: 1, is_hidden_event=lambda: False,
            is_user_annotation=lambda: note)

    events = [event("repro_torch.step.forward", DeviceType.CPU, 0, 9000,
                    note=True),
              event("repro_torch.step.forward", DeviceType.CUDA, 1000,
                    8000, note=True),
              event("nvjet_gemm", DeviceType.CUDA, 1000, 3000),
              event("elementwise_kernel", DeviceType.CUDA, 3000, 8000)]
    results = SimpleNamespace(trace_start_ns=lambda: 0,
                              events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    assert chip_smoke._trace_totals(prof, DeviceType.CUDA) == {
        "nvjet_gemm": [2.0, 1], "elementwise_kernel": [5.0, 1]}
    assert chip_smoke._trace_totals(prof, DeviceType.CPU) == {
        "repro_torch.step.forward": [9.0, 1]}


class _Ev:
    """The ``_KinetoEvent`` methods the smoke's span attribution reads."""

    def __init__(self, name, start, end, *, cuda=False, corr=0, linked=0,
                 tid=1, note=False):
        from torch.autograd import DeviceType
        self.name = lambda: name
        self.start_ns, self.end_ns = (lambda: start), (lambda: end)
        self.correlation_id = lambda: corr
        self.linked_correlation_id = lambda: linked
        self.start_thread_id = lambda: tid
        self.is_user_annotation = lambda: note
        self.device_type = lambda: DeviceType.CUDA if cuda else DeviceType.CPU


SG, MB = "repro_torch.executor.step_group", "repro_torch.step.micro_batch"
FWD, BWD = "repro_torch.step.forward", "repro_torch.step.backward"
ACC, OPT = "repro_torch.step.accumulate", "repro_torch.step.optimizer"
UNIT, ATT = "repro_torch.model.unit", "repro_torch.kernels.attention"
ATT_BWD = "repro_torch.kernels.attention_bwd"


def _span(name, s, e, tid=1):
    return _Ev(name, s, e, tid=tid, note=True)


def _launch(op, s, e, kernel, ks, ke, *, corr, tid=1, at=None):
    """A host operator (``corr``), its runtime call at ``at`` and the
    device operation it launched, linked as torch links them."""
    rows = [_Ev(op, s, e, corr=corr, tid=tid),
            _Ev(kernel, ks, ke, cuda=True, corr=corr + 5000, linked=corr)]
    if at is not None:
        rows.append(_Ev("cudaLaunchKernel", at, at + 1, corr=corr + 5000,
                        linked=corr, tid=99))
    return rows


def _step_events(unlinked_ns=0):
    """One group step of one micro-batch: the phases on thread 1, the
    recompute and the attention's backward on autograd's thread 2."""
    ev = [_span(SG, 0, 2000), _span(MB, 10, 1900), _span(FWD, 20, 300),
          _span(BWD, 300, 1800), _span(ACC, 1800, 1890),
          _span(OPT, 1900, 1990), _span(UNIT, 25, 290), _span(ATT, 100, 150),
          _span(UNIT, 400, 600, tid=2), _span(ATT_BWD, 650, 800, tid=2),
          _span("repro_torch.gc", 1200, 1300),
          # a span's copy on the device's timeline is no device work
          _Ev(FWD, 20, 300, cuda=True, note=True)]
    ev += _launch("aten::mm", 30, 40, "nvjet_mm", 1000, 1100, corr=1)
    ev += _launch("FlashAttention", 110, 140, "flash_fwd_mma_kernel<64>",
                  1100, 1200, corr=2)
    ev += _launch("aten::mul", 410, 420, "elementwise_mul", 1400, 1500,
                  corr=3, tid=2)
    # the backward node opens before its span: the runtime call's instant
    ev += _launch("FlashAttentionBackward", 640, 810,
                  "flash_bwd_dq_mma_kernel<64>", 1500, 1600, corr=4, tid=2,
                  at=700)
    ev += _launch("aten::add_", 1810, 1820, "add", 1600, 1650, corr=5)
    ev += _launch("aten::mul", 1910, 1920, "adam", 1650, 1850, corr=6)
    if unlinked_ns:
        ev.append(_Ev("orphan_kernel", 1850, 1850 + unlinked_ns, cuda=True,
                      corr=7000))
    return ev


def test_span_chains_climb_the_launching_thread_and_take_the_step_phase():
    got = chip_smoke._span_chains(_step_events())
    assert got == [
        (100, (SG, MB, FWD, UNIT)), (100, (SG, MB, FWD, UNIT, ATT)),
        # thread 2 has no step span: it takes thread 1's open at the launch
        (100, (SG, MB, BWD, UNIT)), (100, (SG, MB, BWD, ATT_BWD)),
        (50, (SG, MB, ACC)), (200, (SG, OPT))]


def test_span_chains_without_the_runtime_call_or_the_link():
    ev = [e for e in _step_events(unlinked_ns=3)
          if e.name() != "cudaLaunchKernel"]
    got = chip_smoke._span_chains(ev)
    # the operator's start stands for the launch, before the call's span
    assert got[3] == (100, (SG, MB, BWD))
    assert got[-1] == (3, None)


def test_span_fields_put_a_step_down_to_its_phases():
    from types import SimpleNamespace
    events = _step_events(unlinked_ns=3)
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = chip_smoke._span_fields(prof)
    assert got == {
        "by_phase_ms": {"forward": 200e-6, "backward": 200e-6,
                        "accumulate": 50e-6, "optimizer": 200e-6,
                        "none": 3e-6},
        "recompute_ms": 100e-6,
        "by_call_ms": {"attention": 100e-6, "attention_bwd": 100e-6,
                       "ssd": 0.0, "ssd_bwd": 0.0},
        "micro_batch_spans": 1.0}
    events = [e for e in events if not e.name().startswith("repro_torch.")]
    assert chip_smoke._span_fields(prof) == {}
