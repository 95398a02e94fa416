"""The analysis slice (``nanofed_tpu_torch.analysis``) against the JAX package's
``nanofed_tpu.analysis`` on the CPU: fedlint's rules as written give the JAX
linter's findings on the JAX tests' snippets and on both package trees, the torch
rules (FED001/FED002 over the dispatch scope, FED007 over the mesh's collectives)
fire and miss where they should, the port's own tree is clean with reasoned
suppressions, the meta-tensor contract checks give the JAX ``eval_shape`` checks'
verdicts and leaves, the mesh layout check holds a rank's tensors on described
meshes, ``strict_mode`` restores the sync debug mode, the program audit's mutants
fire exactly their checks (the JAX mutation table less ``donation``), the reference
catalog audits clean on every rank of its described meshes, and the module entry
point keeps the JAX exit codes and JSON shapes."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu import analysis as jax_analysis
from nanofed_tpu.parallel.round_step import RoundStepResult as JaxRoundStepResult
from nanofed_tpu_torch import analysis, ops
from nanofed_tpu_torch.aggregation import fedadam_strategy, fedavg_strategy
from nanofed_tpu_torch.analysis import fedlint, program_audit
from nanofed_tpu_torch.analysis.contracts import (
    ContractViolation,
    check_input_shardings,
    check_round_block,
    check_round_step,
    strict_mode,
)
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability import RunTelemetry, summarize_telemetry
from nanofed_tpu_torch.parallel import (
    build_round_block,
    build_round_step,
    init_server_state,
    round_seeds,
)
from nanofed_tpu_torch.parallel.mesh import (
    CollectiveRecorder,
    Mesh,
    MeshLayout,
    broadcast_object,
    client_slice,
)
from nanofed_tpu_torch.parallel.round_step import RoundStepResult
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.trainer.local import client_keys, draw_permutations

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "nanofed_tpu_torch"
#: The rules the port keeps as the JAX package writes them.
AS_WRITTEN = {"FED000", "FED005", "FED006", "FED008", "FED009", "FED010"}
#: ``tests/integration/test_program_audit.py``'s table: each variant's mesh axes.
VARIANTS = {
    "single_step": {"clients"},
    "fused_block": {"clients"},
    "scaffold": {"clients"},
    "fsdp_2d": {"clients", "model"},
    "hier_3axis": {"hosts", "clients", "model"},
    "adapter": {"clients"},
    "drained_ingest": {"hosts", "clients", "model"},
}


def _found(diags) -> list[tuple[str, int, int]]:
    return [(d.code, d.line, d.col) for d in diags]


# ---------------------------------------------------------------------------
# fedlint: the rules as written, on the JAX tests' snippets
# ---------------------------------------------------------------------------

# Copied from ``tests/unit/analysis/test_fedlint.py``: (case, module, source).
FEDLINT_SNIPPETS = [
    ('TestFed000.test_reasonless_suppression_is_flagged.0', 'fixture', """
import jax

def sample(key):
    a = jax.random.uniform(key, (3,))
    b = jax.random.normal(key, (3,))  # fedlint: disable=FED003
    return a + b
"""),
    ('TestFed000.test_reasoned_suppression_is_honored.0', 'fixture', """
import jax

def sample(key):
    a = jax.random.uniform(key, (3,))
    b = jax.random.normal(key, (3,))  # fedlint: disable=FED003 (correlated on purpose: antithetic pair)
    return a + b
"""),
    ('TestFed006.test_time_sleep_flagged.0', 'fixture', """
import time

async def poll(server):
    time.sleep(1.0)
    return server.done
"""),
    ('TestFed006.test_sync_file_io_flagged.0', 'fixture', """
async def dump(path, payload):
    with open(path, "w") as f:
        f.write(payload)
    path.write_text(payload)
"""),
    ('TestFed006.test_asyncio_sleep_and_to_thread_are_clean.0', 'fixture', """
import asyncio

async def poll(server):
    await asyncio.sleep(1.0)
    return await asyncio.to_thread(server.read)
"""),
    ('TestFed006.test_sync_function_is_out_of_scope.0', 'fixture', """
import time

def poll(server):
    time.sleep(1.0)
    return open("/tmp/x").read()
"""),
    ('TestFed006.test_suppression_honored.0', 'fixture', """
import time

async def poll(server):
    time.sleep(0.001)  # fedlint: disable=FED006 (sub-ms backoff, measured harmless)
    return server.done
"""),
    ('TestFed006UnboundedAwait.test_unbounded_read_in_communication_handler_flagged.0', 'nanofed_tpu.communication.fake', """
class Server:
    async def _handle_update(self, request):
        body = await request.read()
        return body
"""),
    ('TestFed006UnboundedAwait.test_json_and_text_also_flagged.0', 'nanofed_tpu.communication.fake', """
class Server:
    async def _handle_register(self, request):
        a = await request.json()
        b = await request.text()
        return a, b
"""),
    ('TestFed006UnboundedAwait.test_wait_for_wrapped_read_is_clean.0', 'nanofed_tpu.communication.fake', """
import asyncio

class Server:
    async def _handle_update(self, request):
        body = await asyncio.wait_for(request.read(), timeout=30.0)
        return body
"""),
    ('TestFed006UnboundedAwait.test_helper_indirection_is_clean.0', 'nanofed_tpu.communication.fake', """
class Server:
    async def _handle_update(self, request):
        body = await self._read_body(request)
        return body
"""),
    ('TestFed006UnboundedAwait.test_non_handler_and_other_packages_out_of_scope.0', 'nanofed_tpu.communication.fake', """
class Client:
    async def fetch(self, resp):
        return await resp.read()
"""),
    ('TestFed006UnboundedAwait.test_non_handler_and_other_packages_out_of_scope.1', 'nanofed_tpu.orchestration.fake', """
class Server:
    async def _handle_update(self, request):
        body = await request.read()
        return body
"""),
    ('TestFed008.test_dropped_result_flagged.0', 'fixture', """
import asyncio

async def kick(coro):
    asyncio.create_task(coro)
"""),
    ('TestFed008.test_assigned_but_never_sunk_flagged.0', 'fixture', """
import asyncio

async def kick(coro):
    task = asyncio.create_task(coro)
    await asyncio.sleep(1)
"""),
    ('TestFed008.test_done_callback_is_a_sink.0', 'fixture', """
import asyncio

async def kick(coro, log_exc):
    task = asyncio.create_task(coro)
    task.add_done_callback(log_exc)
    await asyncio.sleep(1)
"""),
    ('TestFed008.test_plain_await_is_a_sink.0', 'fixture', """
import asyncio

async def kick(coro):
    task = asyncio.create_task(coro)
    return await task
"""),
    ('TestFed008.test_broadly_swallowed_await_is_not_a_sink.0', 'fixture', """
import asyncio

async def kick(coro):
    task = asyncio.create_task(coro)
    task.cancel()
    try:
        await task
    except (asyncio.CancelledError, Exception):
        pass
"""),
    ('TestFed008.test_gather_and_wait_count_as_sinks.0', 'fixture', """
import asyncio

async def kick(a, b):
    t1 = asyncio.create_task(a)
    t2 = asyncio.ensure_future(b)
    await asyncio.gather(t1)
    done, _ = await asyncio.wait({t2})
"""),
    ('TestFed008.test_self_attribute_sunk_in_other_method_is_clean.0', 'fixture', """
import asyncio

class Tracker:
    def start(self, coro):
        self._task = asyncio.create_task(coro)

    async def stop(self):
        await self._task
"""),
    ('TestFed008.test_self_attribute_never_sunk_flagged.0', 'fixture', """
import asyncio

class Tracker:
    def start(self, coro):
        self._task = asyncio.create_task(coro)
"""),
    ('TestFed008.test_suppression_honored.0', 'fixture', """
import asyncio

async def kick(coro):
    asyncio.create_task(coro)  # fedlint: disable=FED008 (daemon heartbeat: failure is surfaced by the watchdog)
"""),
    ('TestFed009.test_json_dump_in_async_def_flagged.0', 'fixture', """
import json

async def persist(state, f):
    json.dump(state, f)
"""),
    ('TestFed009.test_path_method_flagged.0', 'fixture', """
async def cleanup(path):
    path.unlink()
"""),
    ('TestFed009.test_nested_def_payload_is_exempt.0', 'fixture', """
import asyncio
import json

async def persist(state, f):
    def _write():
        json.dump(state, f)
    await asyncio.to_thread(_write)
"""),
    ('TestFed009.test_sync_function_is_out_of_scope.0', 'fixture', """
import json

def persist(state, f):
    json.dump(state, f)
"""),
    ('TestFed009.test_suppression_honored.0', 'fixture', """
import os

async def rotate(src, dst):
    os.replace(src, dst)  # fedlint: disable=FED009 (atomic rename on tmpfs: sub-microsecond, cheaper than a thread hop)
"""),
    ('TestFed010.test_time_time_in_communication_flagged.0', 'nanofed_tpu.communication.fixture', """
import time

def stamp():
    return time.time()
"""),
    ('TestFed010.test_datetime_now_in_service_flagged.0', 'nanofed_tpu.service.fixture', """
import datetime

def stamp():
    return datetime.datetime.now()
"""),
    ('TestFed010.test_injected_clock_is_clean.0', 'nanofed_tpu.loadgen.fixture', """
def stamp(clock):
    return clock.now()
"""),
    ('TestFed010.test_other_packages_out_of_scope.0', 'nanofed_tpu.models.fixture', """
import time

def stamp():
    return time.time()
"""),
    ('TestFed010.test_suppression_honored.0', 'nanofed_tpu.observability.fixture', """
import time

def stamp():
    return time.time()  # fedlint: disable=FED010 (forensics-only stamp: aligns the jsonl with external logs)
"""),
]

_SERVER_TEMPLATE = """
import asyncio


class Server:
    def __init__(self):
        self._lock = asyncio.Lock()
        self._updates = {}
        self._round = 0

    async def submit(self, cid, update):
        async with self._lock:
            self._updates[cid] = update

__EXTRA__
"""
FEDLINT_SNIPPETS += [
    (f"TestFed005.{case}", "fixture", _SERVER_TEMPLATE.replace("__EXTRA__", extra))
    for case, extra in (
        ("test_unlocked_mutation_of_guarded_attr_flagged",
         "    def reset(self):\n        self._updates.clear()\n"),
        ("test_locked_everywhere_is_clean",
         "    async def reset(self):\n        async with self._lock:\n"
         "            self._updates.clear()\n"),
        ("test_unguarded_attr_is_not_flagged",
         "    def advance(self):\n        self._round += 1\n"),
        ("test_suppression_honored",
         "    def reset(self):\n        # fedlint: disable=FED005 (sync method on the event "
         "loop: no await point, handlers cannot interleave)\n        self._updates.clear()\n"),
    )
]


@pytest.mark.parametrize("case,module,src", FEDLINT_SNIPPETS,
                         ids=[c for c, _, _ in FEDLINT_SNIPPETS])
def test_rules_as_written_give_the_jax_findings(case, module, src):
    want = _found(jax_analysis.lint_source(src, module=module, select=AS_WRITTEN))
    got = _found(analysis.lint_source(src, module=module, select=AS_WRITTEN))
    assert got == want


def test_the_snippets_exercise_every_rule_as_written():
    fired = {d.code for _, module, src in FEDLINT_SNIPPETS
             for d in analysis.lint_source(src, module=module)}
    assert fired == AS_WRITTEN


@pytest.mark.parametrize("tree", ["nanofed_tpu", "nanofed_tpu_torch"])
def test_both_linters_agree_on_both_trees(tree):
    """The rules as written over each package's tree: the two linters find the same
    (nothing, once every finding of the port is fixed or suppressed with a reason)."""
    want = _found(jax_analysis.lint_paths([REPO / tree], select=AS_WRITTEN))
    got = _found(analysis.lint_paths([REPO / tree], select=AS_WRITTEN))
    assert got == want == []


# ---------------------------------------------------------------------------
# fedlint: the torch rules
# ---------------------------------------------------------------------------

_STEP = """
import torch


def build_round_step(model):
    def helper(w: torch.Tensor):
        return {body}

    def round_step(params, weights: torch.Tensor, lr_scale: float = 1.0):
        total = weights.sum()
        {line}
        return helper(weights)

    return round_step
"""

TORCH_RULES = [
    # (case, module, source, findings as (code, line))
    ("FED001 float() of a tensor in the dispatch", "fixture",
     _STEP.format(body="w", line="scale = float(total)"), [("FED001", 11)]),
    ("FED001 near miss: float() of a host value", "fixture",
     _STEP.format(body="w", line="scale = float(lr_scale)"), []),
    ("FED001 .item() reached through a call edge", "fixture",
     _STEP.format(body="w.sum().item()", line="pass"), [("FED001", 7)]),
    ("FED001 near miss: .item() outside the dispatch scope", "fixture",
     "def report(w):\n    return w.sum().item()\n", []),
    ("FED001 torch.cuda.synchronize in the hot path", "nanofed_tpu_torch.orchestration.fake",
     "import torch\n\ndef barrier():\n    torch.cuda.synchronize()\n", [("FED001", 4)]),
    ("FED001 near miss: a synchronize outside the hot path", "nanofed_tpu_torch.models.fake",
     "import torch\n\ndef barrier():\n    torch.cuda.synchronize()\n", []),
    ("FED001 near miss: a reasoned hot-path suppression",
     "nanofed_tpu_torch.orchestration.fake",
     "import torch\n\ndef barrier():\n    # fedlint: disable=FED001 (the block's one barrier, "
     "after the whole block is enqueued)\n    torch.cuda.synchronize()\n", []),
    ("FED002 if on a tensor in the dispatch", "fixture",
     _STEP.format(body="w", line="if total > 0:\n            pass"), [("FED002", 11)]),
    ("FED002 near miss: if on a shape and on None", "fixture",
     _STEP.format(body="w", line="if weights.shape[0] > 2 and params is not None:\n"
                  "            pass"), []),
    ("FED007 raw torch.distributed collective", "nanofed_tpu_torch.parallel.fake",
     "import torch.distributed as dist\n\ndef reduce(x):\n    dist.all_reduce(x)\n",
     [("FED007", 4)]),
    ("FED007 an axis-name literal indexing mesh.groups", "nanofed_tpu_torch.aggregation.fake",
     "def group(mesh):\n    return mesh.groups['clients']\n", [("FED007", 2)]),
    ("FED007 near miss: the mesh module and the axis constants",
     "nanofed_tpu_torch.parallel.mesh",
     "import torch.distributed as dist\n\ndef reduce(x, mesh):\n"
     "    dist.all_reduce(x, group=mesh.groups['clients'])\n", []),
    ("FED007 near miss: the axis constant and MeshLayout", "nanofed_tpu_torch.parallel.fake",
     "from nanofed_tpu_torch.parallel.mesh import CLIENT_AXIS\n\ndef reduce(x, layout, mesh):\n"
     "    mesh.groups.get(CLIENT_AXIS)\n    return layout.client_psum(x)\n", []),
]


@pytest.mark.parametrize("case,module,src,want", TORCH_RULES,
                         ids=[c for c, *_ in TORCH_RULES])
def test_torch_rules_fire_and_miss(case, module, src, want):
    got = [(d.code, d.line) for d in analysis.lint_source(textwrap.dedent(src), module=module)]
    assert got == want


def test_dropped_rules_leave_the_catalogue_with_their_reasons():
    """FED003 and FED004 are dropped (stated difference): no rule, a reason each, and
    a JAX key-reuse or jit snippet is no finding here."""
    assert set(fedlint.DROPPED_RULES) == {"FED003", "FED004"}
    assert set(jax_analysis.RULES) == set(analysis.RULES) | set(fedlint.DROPPED_RULES)
    assert all(len(reason) >= 15 for reason in fedlint.DROPPED_RULES.values())
    src = ("import jax\n\ndef sample(key):\n    a = jax.random.uniform(key, (3,))\n"
           "    return a + jax.random.normal(key, (3,))\n")
    assert [d.code for d in jax_analysis.lint_source(src)] == ["FED003"]
    assert analysis.lint_source(src) == []


# ---------------------------------------------------------------------------
# The self-lint gate (the twin of tests/integration/test_self_lint.py)
# ---------------------------------------------------------------------------


def test_package_is_fedlint_clean():
    diagnostics = analysis.lint_paths([PACKAGE])
    assert diagnostics == [], "\n" + analysis.render_text(diagnostics)


def test_suppressions_exist_and_carry_reasons():
    """The clean result comes from DOCUMENTED intentional sites, not from rules that
    never fire: the tree carries FED001 suppressions (the coordinator's barriers, the
    client keys' host seed words) and FED005 ones (the server's lock-held helpers), and
    each states a real reason.  The fused block and the robust estimators carry none:
    their counts stay on the device."""
    pattern = re.compile(r"#\s*fedlint:\s*disable(?:-file)?=([A-Z0-9,\s]+?)\s*\(([^)]+)\)")
    found = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for line in path.read_text().splitlines():
            m = pattern.search(line)
            if m:
                found.append((path.name, m.group(1).strip(), m.group(2).strip()))
    codes = {code for _, code, _ in found}
    assert {"FED001", "FED005"} <= codes, found
    sites = {(name, code) for name, code, _ in found}
    assert {("local.py", "FED001"), ("coordinator.py", "FED001"),
            ("http_server.py", "FED005")} <= sites
    assert not {("multi_round.py", "FED001"), ("robust.py", "FED001")} & sites
    for fname, code, reason in found:
        assert len(reason) >= 15, f"{fname}: suppression of {code} has a token reason"


def test_rule_catalogue_matches_the_docstring():
    documented = set(re.findall(r"^- \*\*(FED\d{3})\*\*", fedlint.__doc__, re.MULTILINE))
    assert documented == set(analysis.RULES)


# ---------------------------------------------------------------------------
# Contracts: the JAX unit cases on both packages
# ---------------------------------------------------------------------------

N, DIM = 4, 3


def _jax_args():
    sds = jax.ShapeDtypeStruct
    return ({"w": sds((DIM,), jnp.float32), "b": sds((), jnp.float32)},
            {"momentum": sds((DIM,), jnp.float32)},
            {"x": sds((N, 8, DIM), jnp.float32), "y": sds((N, 8), jnp.int32)},
            sds((N,), jnp.float32),
            jax.eval_shape(lambda: jax.random.split(jax.random.key(0), N)))


def _jax_good(params, sos, data, weights, rngs, lr_scale=1.0):
    return JaxRoundStepResult(
        params=params, server_opt_state=sos,
        metrics={"loss": jnp.zeros(()), "accuracy": jnp.zeros(())},
        client_metrics={"loss": jnp.zeros(weights.shape[0])},
        update_sq_norms=jnp.zeros(weights.shape[0]))


def _port_args():
    return ({"w": torch.zeros(DIM), "b": torch.zeros(())}, {"momentum": torch.zeros(DIM)},
            {"x": torch.zeros(N, 8, DIM), "y": torch.zeros(N, 8, dtype=torch.int32)},
            torch.ones(N), torch.zeros(N, 1, 8, dtype=torch.int64))


def _port_good(params, sos, data, weights, perms, keys=None, noise=None, lr_scale=1.0):
    return RoundStepResult(
        params=params, server_opt_state=sos,
        metrics={"loss": torch.zeros(()), "accuracy": torch.zeros(())},
        client_metrics={"loss": torch.zeros(weights.shape[0])},
        update_sq_norms=torch.zeros(weights.shape[0]))


# case -> how the step's result drifts (applied to either package's result).
CONTRACT_CASES = {
    "conforming": lambda res, np_: res,
    "param_shape_drift": lambda res, np_: res._replace(
        params={"w": res.params["w"][None], "b": res.params["b"]}),
    "structure_drift": lambda res, np_: res._replace(params={"w": res.params["w"]}),
    "nonscalar_metric": lambda res, np_: res._replace(metrics={"loss": np_.zeros(N)}),
    "wrong_client_width": lambda res, np_: res._replace(update_sq_norms=np_.zeros(2)),
}


def _verdict(check, exc):
    """``None`` when the check passes, else the leaf it names, as a ``/``-path (the JAX
    message's ``keystr`` mapped: ``params['w']`` -> ``params/w``)."""
    try:
        check()
    except exc as e:
        head = str(e).split(":")[0]
        path = re.sub(r"\['([^']*)'\]", r"/\1", head)
        return "structure" if "tree structure" in str(e) else path
    return None


@pytest.mark.parametrize("case", list(CONTRACT_CASES))
def test_round_step_contract_gives_the_jax_verdict(case):
    drift = CONTRACT_CASES[case]
    want = _verdict(lambda: jax_analysis.check_round_step(
        lambda *a, **k: drift(_jax_good(*a, **k), jnp), *_jax_args()),
        jax_analysis.ContractViolation)
    got = _verdict(lambda: check_round_step(
        lambda *a, **k: drift(_port_good(*a, **k), torch), *_port_args()), ContractViolation)
    assert got == want
    assert (want is None) == (case == "conforming")


def test_a_real_round_block_conforms_as_in_jax():
    """The JAX test's real block (``linear`` over 4 clients of 8 samples, 3 rounds) and
    the port's: the same report."""
    from nanofed_tpu.aggregation import fedavg_strategy as jax_fedavg
    from nanofed_tpu.data import pack_clients as jax_pack
    from nanofed_tpu.data import synthetic_classification as jax_synthetic
    from nanofed_tpu.models import get_model as jax_get_model
    from nanofed_tpu.parallel import build_round_block as jax_block
    from nanofed_tpu.parallel import init_server_state as jax_init
    from nanofed_tpu.parallel import make_mesh, pad_client_count, pad_clients
    from nanofed_tpu.parallel import shard_client_data, stack_round_keys
    from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig

    rpb, parts = 3, [np.arange(i * 8, (i + 1) * 8) for i in range(4)]
    jmodel = jax_get_model("linear", in_features=6, num_classes=3)
    mesh = make_mesh()
    padded = pad_client_count(4, len(mesh.devices.flat))
    jdata = shard_client_data(pad_clients(jax_pack(jax_synthetic(32, 3, (6,), seed=0), parts,
                                                   batch_size=8), padded), mesh)
    jparams = jmodel.init(jax.random.key(0))
    want = jax_analysis.check_round_block(
        jax_block(jmodel.apply, JaxTrainingConfig(batch_size=8, local_epochs=1), mesh,
                  jax_fedavg(), num_clients=4, padded_clients=padded),
        jparams, jax_init(jax_fedavg(), jparams), jdata,
        jnp.asarray(np.asarray(jdata.mask).sum(axis=1), jnp.float32),
        jax.eval_shape(lambda: stack_round_keys(0, list(range(rpb)))),
        jax.ShapeDtypeStruct((rpb,), jnp.float32),
        cohort_mask=jax.ShapeDtypeStruct((rpb, padded), jnp.float32))

    from nanofed_tpu_torch.data import pack_clients

    model = get_model("linear", in_features=6, num_classes=3)
    data = pack_clients(synthetic_classification(32, 3, (6,), seed=0), parts,
                        batch_size=8).to(torch.device("cpu"))
    params = model.init(torch.Generator().manual_seed(0))
    got = check_round_block(
        build_round_block(model, TrainingConfig(batch_size=8, local_epochs=1),
                          fedavg_strategy(), num_clients=4, device="cpu"),
        params, init_server_state(fedavg_strategy(), params), data, data.mask.sum(1),
        round_seeds(0, range(rpb)), [1.0] * rpb, cohort_mask=torch.ones(rpb, 4))
    keys = ("program", "rounds", "params_leaves", "client_detail")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert set(want["metrics"]) <= set(got["metrics"])


@pytest.fixture(scope="module")
def mlp_round():
    model = get_model("mlp", in_features=8, hidden=16, num_classes=3)
    data = federate(synthetic_classification(128, 3, (8,), seed=0), num_clients=8,
                    batch_size=16).to(torch.device("cpu"))
    params = model.init(torch.Generator().manual_seed(0))
    perms = draw_permutations(torch.Generator().manual_seed(0), 8, 1, data.y.shape[1])
    return model, data, params, perms


def test_nothing_executes_in_a_contract_check(mlp_round):
    """A real streamed round step is checked with no kernel launched and its inputs
    untouched, and a step that would raise on real data (an index out of range) is not
    run on it: only its shapes are."""
    model, data, params, perms = mlp_round
    step = build_round_step(model, TrainingConfig(batch_size=16, local_epochs=1),
                            fedadam_strategy(0.05), client_chunk=4)
    sos = init_server_state(fedadam_strategy(0.05), params)
    before, counts = {k: v.clone() for k, v in params.items()}, ops.launch_counts()
    report = check_round_step(step, params, sos, data, torch.ones(8), perms,
                              client_keys(0, 8, "cpu"))
    assert report["clients"] == 8 and ops.launch_counts() == counts
    assert all(torch.equal(params[k], before[k]) for k in params)
    ran = []

    def out_of_range(params, sos, data, weights, perms, keys=None, noise=None, lr_scale=1.0):
        ran.append(True)
        weights[torch.full((1,), 99)]  # an IndexError on real data
        return _port_good(params, sos, data, weights, perms)

    with pytest.raises(IndexError):
        out_of_range(*_port_args())
    check_round_step(out_of_range, *_port_args())
    assert ran == [True, True]


def test_a_host_read_is_a_contract_finding_named_by_op_and_line():
    def reads(params, sos, data, weights, perms, keys=None, noise=None, lr_scale=1.0):
        if float(weights.sum()) > 0:  # a read of a device value
            pass
        return _port_good(params, sos, data, weights, perms)

    with pytest.raises(ContractViolation, match=r"_local_scalar_dense at "
                                                r"tests/test_torch_analysis\.py:\d+ \(reads\)"):
        check_round_step(reads, *_port_args())


@pytest.mark.parametrize("shape", [(4,), (2, 2), (2, 2, 1)])
def test_input_layout_on_described_meshes(shape, mlp_round):
    """Every rank's rows and model shard pass; data cut on the wrong rows (over every
    rank, the model axis included, or not cut at all), and a param cut on the client
    axis where a model shard belongs, fail."""
    _, data, params, _ = mlp_round
    n = int(np.prod(shape))
    for rank in range(n):
        mesh = Mesh.describe(shape, rank)
        lo, hi = client_slice(8, mesh)
        shard = MeshLayout(mesh, params).shard_params(params)
        check_input_shardings(data.select(slice(lo, hi)), shard, mesh, padded_clients=8,
                              params_like=params)
        own = {hi - lo, 8 // mesh.dims[0]}  # this rank's rows, its host's rows
        wrong = [rows for rows in (1, 2, 4, 8) if rows not in own]
        assert len(wrong) == 2
        for rows in wrong:
            with pytest.raises(ContractViolation, match="client rows"):
                check_input_shardings(data.select(slice(0, rows)), shard, mesh,
                                      padded_clients=8, params_like=params)
    # A client-axis cut of the largest leaf, on a rank whose client and model
    # coordinates differ (or, without a model axis, any cut at all).
    mesh = Mesh.describe(shape, 1)
    n_cli = mesh.dims[1]
    name = max(params, key=lambda k: params[k].numel())
    leaf = params[name]
    dim = int(np.argmax(leaf.shape))
    size = leaf.shape[dim] // n_cli
    cut = dict(MeshLayout(mesh, params).shard_params(params))
    cut[name] = leaf.narrow(dim, mesh.coords["clients"] * size, size)
    with pytest.raises(ContractViolation, match=f"params/{name}"):
        check_input_shardings(data.select(slice(*client_slice(8, mesh))), cut, mesh,
                              padded_clients=8, params_like=params)


def test_strict_mode_restores_the_previous_mode_on_the_cpu(monkeypatch):
    """A no-op on a CPU-only build; where CUDA is (faked here) it arms "error" and puts
    back the previous mode, after an exception too."""
    with strict_mode():
        assert float(torch.ones(2).sum()) == 2.0  # nothing to guard on the CPU
    modes = ["warn"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with strict_mode("cuda"):
        assert modes[-1] == "error"
    assert modes[-1] == "warn"
    with pytest.raises(ValueError, match="boom"):
        with strict_mode():
            raise ValueError("boom")
    assert modes == ["warn", "error", "warn", "error", "warn"]
    with strict_mode("cpu"):  # a CPU device arms nothing
        pass
    assert len(modes) == 5


# ---------------------------------------------------------------------------
# The collective recorder and meta dispatch
# ---------------------------------------------------------------------------


def test_collectives_record_on_a_described_mesh_and_raise_without_a_recorder():
    mesh = Mesh.describe((2, 2, 2), 3)
    layout = MeshLayout(mesh, {})
    x = torch.ones(5)
    with pytest.raises(RuntimeError, match="described mesh"):
        layout.client_psum(x)
    with CollectiveRecorder() as rec:
        assert torch.equal(layout.client_psum(x), x)
        assert layout.client_all_gather(torch.ones(3, 2)).shape == (12, 2)
        assert broadcast_object("pick") == "pick"
    assert [(r.op, r.axis, r.shape, r.bytes) for r in rec.records] == [
        ("all_reduce", "clients", (5,), 20), ("all_reduce", "hosts", (5,), 20),
        ("all_gather", "clients", (3, 2), 24), ("all_gather", "hosts", (6, 2), 48),
        ("broadcast_object", "world", (), 0)]


def test_meta_tensors_take_the_plain_versions_and_mixed_devices_raise():
    x, w = torch.empty(3, 8, device="meta"), torch.empty(3, device="meta")
    before = ops.launch_counts()
    assert ops.weighted_mean_flat(x, w).shape == (8,) and ops.row_sq_norms(x).shape == (3,)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="all be on the CPU or all on one GPU"):
        ops.weighted_mean_flat(x, torch.ones(3))


# ---------------------------------------------------------------------------
# The program audit
# ---------------------------------------------------------------------------


def test_mutation_suite_proves_every_check(devices):
    """Each seeded mutant fires exactly its check, and the table of mutants and checks
    is the JAX suite's less its donation mutant (``donation`` is dropped).  The JAX
    table is read from ``seeded_mutants()``: auditing them fails under this host's jax
    (``jax.core.ClosedJaxpr`` is gone), so the JAX verdicts are no oracle."""
    from nanofed_tpu.analysis.program_audit import seeded_mutants as jax_seeded_mutants

    results = analysis.run_mutation_suite()
    for name, r in results.items():
        assert r["ok"], f"mutant {name}: expected [{r['expected']}], fired {r['fired']}"
    theirs = {name: check for name, check, *_ in jax_seeded_mutants()}
    assert {name: r["expected"] for name, r in results.items()} == {
        name: check for name, check in theirs.items() if check != "donation"}
    assert set(analysis.AUDIT_CHECKS) == set(jax_analysis.AUDIT_CHECKS) - {"donation"}
    assert set(program_audit.DROPPED_CHECKS) == {"donation"}


@pytest.fixture(scope="module")
def catalog():
    return program_audit.reference_catalog(device="cpu")


@pytest.fixture(scope="module")
def reports(catalog):
    return {r.program: r for r in catalog.audit_all()}


def test_every_variant_audits_clean_on_every_rank(reports):
    assert set(reports) == set(VARIANTS)
    for name, rep in reports.items():
        assert rep.ok, f"{name}: {[f.render() for f in rep.findings]}"
        assert rep.schedule, f"{name}: empty collective schedule"
        assert set(rep.mesh_axes) == VARIANTS[name]
        assert rep.attrs["variant"] == name and rep.ranks == 8
        assert rep.checks == analysis.AUDIT_CHECKS and rep.compiled


def test_hierarchical_variant_orders_its_reduces_and_the_drain_crosses_hosts_once(reports):
    hier = reports["hier_3axis"].schedule
    assert "all_reduce@hosts" in hier
    assert hier.index("all_reduce@clients") < hier.index("all_reduce@hosts")
    assert reports["drained_ingest"].schedule == ("all_reduce@clients", "all_reduce@hosts")


def test_the_drained_reduce_moves_one_hosts_all_reduce_of_p_plus_1(catalog):
    fn, factory, _, attrs = catalog.registration("drained_ingest")
    with CollectiveRecorder() as rec:
        fn(*factory()[0])
    assert [(r.op, r.axis, r.shape) for r in rec.records if r.axis == "hosts"] == [
        ("all_reduce", "hosts", (97,))]


def test_a_divergent_rank_and_a_raw_hosts_reduce_are_findings():
    """A program whose rank 1 skips the clients reduce (collective-schedule) and one
    that reduces over hosts first (mesh-discipline), on a described (2, 2, 2) mesh."""
    def skips(mesh, x):
        return x if mesh.rank == 1 else MeshLayout(mesh, {}).client_psum(x)

    rep = analysis.audit_program("skips", program_audit.RankPrograms((2, 2, 2), skips),
                                 torch.ones(4))
    assert [f.check for f in rep.findings] == ["collective-schedule"]
    assert "rank 1 runs [no collectives]" in rep.findings[0].message


def test_the_single_step_reads_no_counter_back(mlp_round):
    """The single round step keeps Adam's count on the device: under the audit's
    recorder it makes no ``_local_scalar_dense`` (the fix of round_step.py's gate),
    and it returns the count as a 0-d tensor."""
    model, data, params, perms = mlp_round
    step = build_round_step(model, TrainingConfig(batch_size=16, local_epochs=1),
                            fedadam_strategy(0.05))
    sos = init_server_state(fedadam_strategy(0.05), params)
    assert sos["count"] == 0
    rep = analysis.audit_program("round_step", step, params, sos, data, torch.ones(8),
                                 perms, client_keys(0, 8, "cpu"))
    assert rep.ok, [f.render() for f in rep.findings]
    out = step(params, sos, data, torch.ones(8), perms, client_keys(0, 8, "cpu"))
    assert torch.is_tensor(out.server_opt_state["count"])
    assert int(out.server_opt_state["count"]) == 1


def test_audit_records_reach_the_summary_last_one_wins(tmp_path):
    telemetry = RunTelemetry(tmp_path)
    first = analysis.audit_program("p", lambda x: x * float(x.sum()), torch.ones(2))
    second = analysis.audit_program("p", lambda x: x * 2.0, torch.ones(2))
    for rep in (first, second):
        telemetry.record("audit", **rep.to_dict())
    telemetry.close()
    audits = summarize_telemetry(tmp_path / "telemetry.jsonl")["audits"]
    assert audits["clean"] == 1 and audits["dirty"] == 0
    assert audits["programs"]["p"]["ok"] is True and audits["programs"]["p"]["findings"] == []


# ---------------------------------------------------------------------------
# The module entry point (test_module_entry_point_exit_contract's twin)
# ---------------------------------------------------------------------------


def test_module_entry_point_exit_contract(tmp_path, capsys):
    """``python -m nanofed_tpu_torch.analysis``: 0 on a clean file (and every mutant
    firing), 1 on a finding, 2 on an unknown ``--select``; ``--list-rules`` and the
    JSON shapes are the JAX entry point's."""
    from nanofed_tpu_torch.analysis.__main__ import main

    clean, dirty = tmp_path / "clean.py", tmp_path / "dirty.py"
    clean.write_text("x = 1\n")
    dirty.write_text("# fedlint: disable=FED005\nx = 1\n")
    proc = subprocess.run([sys.executable, "-m", "nanofed_tpu_torch.analysis", "--mutants",
                           "--format", "json", str(clean)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["fedlint"] == [] and set(out["mutants"]) and all(
        r["ok"] for r in out["mutants"].values())
    assert main(["--format", "json", str(dirty)]) == 1
    assert [d["code"] for d in json.loads(capsys.readouterr().out)] == ["FED000"]
    assert main(["--select", "FED999", str(clean)]) == 2
    assert "unknown rule code(s): FED999" in capsys.readouterr().err
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listed] == sorted(analysis.RULES)
    assert main([str(clean)]) == 0 and capsys.readouterr().out.strip() == "fedlint: clean"
