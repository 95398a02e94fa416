"""The port's program profiler (``observability.profiling``), its metrics registry and
the aggregation-epilogue table, on the CPU.

The profiler runs a program and counts it (the JAX package's asks the compiler), so
its counts are held to arithmetic here: a matrix product's FLOPs and bytes, views
that move nothing, a vmapped convolution's FLOPs per client whatever the chunk, and
every hand-written kernel's reported bytes to the formula of ``PERF.md``'s bound
column.  Its report keeps the JAX report's keys, the registry renders as the JAX
registry does, and profiling a coordinator leaves its state bit for bit as it was.
"""

import contextlib

import pytest
import torch

from nanofed_tpu.observability import profiling as jax_profiling
from nanofed_tpu.observability.registry import MetricsRegistry as JaxMetricsRegistry
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.aggregation import fedadam_strategy
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability import (
    MetricsRegistry,
    ProgramCatalog,
    format_cost_table,
    peaks_for_device_kind,
    profile_program,
)
from nanofed_tpu_torch.observability.profiling import TIMED_CALLS
from nanofed_tpu_torch.ops import _common, dp_reduce, quantize, reduce
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations, make_local_fit
from nanofed_tpu_torch.tuning import profile_aggregation_epilogues


def _fill(reg) -> None:
    reg.counter("nanofed_rounds_total", "Rounds", labels=("status",)).inc(2, status="ok")
    reg.gauge("nanofed_program_peak_bytes", "Peak", labels=("program",)).set(
        7.5, program='round "step"')
    h = reg.histogram("nanofed_program_compile_seconds", "TTR", labels=("program",),
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 3.0):
        h.observe(v, program="round_step")


def test_registry_renders_as_the_jax_registry():
    port, jax = MetricsRegistry(), JaxMetricsRegistry()
    _fill(port)
    _fill(jax)
    assert port.render_prometheus() == jax.render_prometheus()
    assert port.snapshot() == jax.snapshot()


@pytest.mark.parametrize("kind,platform,has_row", [
    ("NVIDIA H100 80GB HBM3", "cuda", True),
    ("NVIDIA H100 SXM5 80GB", "cuda", True),
    ("NVIDIA A100-SXM4-80GB", "cuda", False),
    ("cpu", "cpu", False),
])
def test_peaks_table_has_the_h100_row_only(kind, platform, has_row):
    peaks = peaks_for_device_kind(kind, platform)
    assert (peaks is not None) == has_row
    if has_row:
        assert (peaks.flops_per_s, peaks.hbm_bytes_per_s) == (989e12, 3.35e12)
        assert "data sheet" in peaks.basis


def test_profile_program_counts_a_matmul_and_keeps_the_jax_keys():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    calls = []

    def program(x, y):
        calls.append(1)
        return x @ y

    report = profile_program("mm", program, a, b)
    assert len(calls) == 2 + TIMED_CALLS  # first, counting, timed
    assert report.flops == 2 * 64 * 32 * 16
    assert report.bytes_accessed == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert report.argument_bytes == 4 * (64 * 32 + 32 * 16)
    assert report.output_bytes == 4 * 64 * 16
    assert report.peak_bytes == 0 and report.verdict == "no peak basis"
    assert report.measured_s > 0 and report.compile_seconds > 0
    jax_report = jax_profiling.ProgramCostReport(
        program="mm", platform="cpu", device_kind="cpu", num_devices=1, rounds=1,
        flops=1.0, transcendentals=0.0, bytes_accessed=1.0, argument_bytes=0,
        output_bytes=0, temp_bytes=0, alias_bytes=0, generated_code_bytes=0,
        peak_bytes=0, compile_seconds=0.0, arithmetic_intensity=1.0)
    assert set(report.to_dict()) == set(jax_report.to_dict()) | {"measured_s"}


def test_views_and_allocations_move_no_bytes():
    x = torch.randn(32, 32)
    report = profile_program("views", lambda t: (t.t(), t.view(-1), t[:4], torch.empty(10)), x)
    assert report.bytes_accessed == 0 and report.flops == 0


def test_grouped_conv_flops_per_client_do_not_depend_on_the_chunk():
    """vmap over per-client weights turns each convolution into a grouped one (a
    group per client); its weight gradient is counted per group, so a client's
    counted FLOPs are the same in a vmap of 1, 2 or 4."""
    model = get_model("mnist_cnn")
    fit = make_local_fit(model, TrainingConfig(batch_size=8, local_epochs=1))
    params = model.init(torch.Generator().manual_seed(0))
    per_client = []
    for k in (1, 2, 4):
        gen = torch.Generator().manual_seed(k)
        data = ClientData(torch.randn(k, 8, 28, 28, 1, generator=gen),
                          torch.randint(0, 10, (k, 8), generator=gen), torch.ones(k, 8))
        report = profile_program("fit", fit, params, data, draw_permutations(gen, k, 1, 8),
                                 client_keys(0, k, "cpu"))
        per_client.append(report.flops / k)
    assert per_client[0] > 0 and per_client == [per_client[0]] * 3


class _FakeLib:
    """Stands in for a kernel library: every entry point 'launches' and returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


def _stub_launches(monkeypatch):
    for module in (reduce, dp_reduce, quantize):
        monkeypatch.setattr(module, "uses_kernel", lambda *tensors: True)
        monkeypatch.setattr(module, "_lib", lambda: _FakeLib())
        monkeypatch.setattr(module, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for module in (reduce, dp_reduce, quantize):  # the plans of B1-B4 and B7's grid
        monkeypatch.setattr(module, "sm_count", lambda index: 132)
    monkeypatch.setattr(dp_reduce, "_workspace", lambda device, stream, rows, pairs: (
        torch.zeros(rows, dtype=torch.int32), torch.empty(pairs)))  # B3's per-stream scratch


C, P = 5, 1003
X = torch.ones(C, P)
W = torch.full((C,), 0.5)
Q8 = torch.ones(C, P, dtype=torch.int8)
U32 = torch.zeros(P, dtype=torch.int32).view(torch.uint32)
BYTE_CASES = {
    # wrapper name: (call, the PERF.md bound column's bytes)
    "weighted_mean_flat": (lambda: ops.weighted_mean_flat(X, W), 4 * C * P + 4 * C + 4 * P),
    "weighted_mean_flat denom": (lambda: ops.weighted_mean_flat(X, W, 2.0),
                                 4 * C * P + 4 * C + 4 + 4 * P),
    "weighted_sum_into": (lambda: ops.weighted_sum_into(torch.zeros(P), X, W),
                          4 * C * P + 4 * C + 8 * P),
    "row_sq_norms": (lambda: ops.row_sq_norms(X), 4 * C * P + 4 * C),
    "masked_weighted_mean_flat": (
        lambda: ops.masked_weighted_mean_flat(X, W, torch.ones(C, dtype=torch.bool)),
        4 * C * P + 4 * C + C + 4 * P),
    "quantize_u32": (lambda: ops.quantize_u32(X[0]), 8 * P),
    "dequantize_u32": (lambda: ops.dequantize_u32(U32), 8 * P),
    "add_mask": (lambda: ops.add_mask(U32, 7, 1), 8 * P),
    "dequant_accumulate_flat": (lambda: ops.dequant_accumulate_flat(Q8, W, W, X[0]),
                                C * P + 8 * P + 12 * C),
}


@pytest.mark.parametrize("case", list(BYTE_CASES))
def test_kernel_bytes_follow_the_perf_formulas(case, monkeypatch):
    """Each wrapper, where it launches, counts the launch and reports the bytes its
    function must move (each input read once, each output written once)."""
    _stub_launches(monkeypatch)
    for fn in ops.KERNELS:  # the stubbed launches must not leak into other tests' counts
        monkeypatch.setattr(fn, "launches", fn.launches)
    call, want = BYTE_CASES[case]
    name = case.split()[0]
    before = ops.launch_counts()[name]
    with _common.KernelBytes() as counted:
        call()
    assert counted.by_kernel == {name: want} and counted.total == want
    assert ops.launch_counts()[name] == before + 1


def test_kernel_bytes_count_only_while_open_and_never_on_the_cpu():
    with _common.KernelBytes() as counted:
        ops.weighted_mean_flat(X, W)  # CPU tensors: the plain version, no launch
    assert counted.by_kernel == {}
    outer = _common.KernelBytes()
    with outer:
        _common.kernel_launched(ops.row_sq_norms, 10)
        with _common.KernelBytes() as inner:
            _common.kernel_launched(ops.row_sq_norms, 5)
    _common.kernel_launched(ops.row_sq_norms, 99)
    assert outer.total == 15 and inner.total == 5
    ops.row_sq_norms.launches -= 3


def test_catalog_is_lazy_caches_publishes_and_refuses_audit():
    registry = MetricsRegistry()
    catalog = ProgramCatalog(registry)
    made = []

    def factory():
        made.append(1)
        return (torch.randn(8, 8), torch.randn(8, 8)), {}

    catalog.register("mm", torch.matmul, args_factory=factory, attrs={"k": 1})
    catalog.register("add", torch.add, args=(torch.ones(3), torch.ones(3)))
    assert made == [] and catalog.names() == ["add", "mm"]
    assert catalog.report("mm") is None
    first = catalog.profile("mm")
    assert catalog.profile("mm") is first and made == [1]
    assert catalog.profile("mm", force=True) is not first and made == [1, 1]
    fn, _, rounds, attrs = catalog.registration("mm")
    assert fn is torch.matmul and rounds == 1 and attrs == {"k": 1}
    assert [r.program for r in catalog.profile_all()] == ["add", "mm"]
    snapshot = registry.snapshot()
    assert snapshot["nanofed_program_flops_total"]["values"]["mm"] == 2 * 8 * 8 * 8
    assert set(snapshot) == {
        "nanofed_program_flops_total", "nanofed_program_peak_bytes",
        "nanofed_program_bytes_accessed", "nanofed_program_arithmetic_intensity",
        "nanofed_program_compile_seconds"}
    table = format_cost_table(catalog.reports())
    assert "mm" in table and "no peak basis" in table
    catalog.remove("add")
    assert catalog.names() == ["mm"]
    # The audit, which the analysis slice brought (ROADMAP item 21): the program runs
    # on meta copies of what its factory makes, nothing is cached, nothing published.
    report = catalog.audit("mm", compile=False)
    assert report.ok and report.schedule == () and made == [1, 1, 1]
    assert report.compiled is False and report.attrs == {"k": 1}
    assert [r.program for r in catalog.audit_all()] == ["mm"] and catalog.report("mm")
    with pytest.raises(KeyError):
        catalog.profile("add")


@pytest.mark.parametrize("participation", [1.0, 0.5])
def test_profile_programs_leaves_the_coordinator_state_bit_equal(tmp_path, participation):
    coord = Coordinator(
        get_model("mnist_cnn"),
        federate(synthetic_classification(64, 10, (28, 28, 1), seed=0), 8, batch_size=8),
        CoordinatorConfig(num_rounds=1, participation_rate=participation, base_dir=tmp_path),
        training=TrainingConfig(batch_size=8, local_epochs=1),
        strategy=fedadam_strategy(), device="cpu",
    )
    coord.run()  # a non-trivial server state
    params = {k: v.clone() for k, v in coord.params.items()}
    state = {k: v.clone() if torch.is_tensor(v) else v for k, v in coord.server_state.items()}
    (report,) = coord.profile_programs()
    assert report.program == "round_step" and report.flops > 0
    assert report.attrs["step_clients"] == coord._step_clients
    for name, p in params.items():
        assert torch.equal(coord.params[name], p)
    for key, v in state.items():
        assert torch.equal(coord.server_state[key], v) if torch.is_tensor(v) else \
            coord.server_state[key] == v
    assert coord.profile_programs()[0] is report  # cached


def test_epilogue_table_on_the_cpu():
    record = profile_aggregation_epilogues(flat_size=65_536, clients=64, device="cpu")
    assert set(record) >= {"flat_size", "clients", "platform", "q8", "validated", "reports",
                           "basis", "measured_ms"}
    assert set(record["reports"]) == {
        "q8_epilogue_dequant", "q8_epilogue_reduce", "q8_epilogue_fused",
        "validated_epilogue_sanitize", "validated_epilogue_reduce",
        "validated_epilogue_fused"}
    assert record["q8"]["bytes_accessed_reduction_pct"] > 0
    assert record["q8"]["unfused_programs"] == ["q8_epilogue_dequant", "q8_epilogue_reduce"]
    assert all(ms > 0 for ms in record["measured_ms"].values())
    assert record["platform"] == "cpu" and "CPU" in record["basis"]
