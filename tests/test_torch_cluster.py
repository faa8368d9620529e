"""The port's modeled offload cluster against the JAX reference's.

``HeroCluster`` failure, restore, resize, re-stage and pin, the runtime
modules over it (``ClusterSupervisor``, ``resize_cluster``,
``run_with_recovery``), the serving cost helpers of ``launch/costing.py``
and ``serve_cluster``.  The cluster is pure-Python float arithmetic in both
packages, so its outputs must be *equal* to the reference's; both sides
are pinned to the reference's default platform (tpu-v5e; the port defaults
to h100-sxm).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import accounting as jacct
from repro.core import cost_model as jcm
from repro.core import hero as jhero
from repro.core.platform import get_platform as jplatform
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro_torch.core import accounting as tacct
from repro_torch.core import cost_model as tcm
from repro_torch.core import hero as thero
from repro_torch.core.platform import get_platform as tplatform
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault_tolerance as tft

SCHEDULERS = ["round-robin", "least-loaded", "cost-aware"]
REF = dict(hero=jhero, cm=jcm, acct=jacct, ft=jft, elastic=jelastic,
           platform=jplatform)
PORT = dict(hero=thero, cm=tcm, acct=tacct, ft=tft, elastic=telastic,
            platform=tplatform)


def _ticket(t):
    return dataclasses.astuple(t)


def _record(r):
    return (r.op, r.shape_key, r.dtype, r.backend, r.note, r.device_id,
            r.resident_fraction, r.count, r.zero_copy,
            dataclasses.astuple(r.cost), dataclasses.astuple(r.regions),
            r.regions.offload_s)


def _state(cluster):
    """Every device's queue, clocks, residency and boot state, and the
    handle ledger."""
    devs = [(d.device_id, d.alive, d.booted, sorted(d.resident),
             [_ticket(t) for t in d.inflight], d.completed_s,
             d.completed_launches, d.dma_free_s, d.compute_free_s)
            for d in cluster.devices]
    handles = sorted((h.name, h.device_id, h.nbytes)
                     for h in cluster._handles.values())
    return devs, handles


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scenario(pkg, scheduler):
    """One sequence of cluster operations; returns everything observable:
    each step's result, the cluster state after it, and the trace."""
    hero, cm, acct = pkg["hero"], pkg["cm"], pkg["acct"]
    cluster = hero.HeroCluster(num_devices=3,
                               platform=pkg["platform"]("tpu-v5e"),
                               scheduler=scheduler)
    cluster.policy = dataclasses.replace(cluster.policy, mode="device")
    log = []

    def launch(m, n, k, key, **kw):
        res = cluster.launch(cm.gemm_cost(m, n, k, 4), dtype="float32",
                             shape_key=key, **kw)
        log.append(("launch", key, str(res), res.device_id))

    with acct.offload_trace() as trace:
        for i, (m, n, k) in enumerate([(64, 64, 64), (256, 128, 512),
                                       (8, 4096, 4096), (128, 128, 128),
                                       (512, 512, 512), (16, 16, 16)]):
            launch(m, n, k, f"g{i}")
        cluster.mark_resident("g1", device_id=2)
        launch(256, 128, 512, "g1")
        kv = cluster.pin_handle("kv0", 3.0e6)
        w = cluster.pin_handle("w0", 8.0e6, device_id=1)
        launch(8, 4096, 4096, "decode", handle=kv)
        log.append(("state", _state(cluster)))
        # A pinned scope: launch and assign_at land on the pinned device.
        with cluster.pin_device(2):
            launch(32, 32, 32, "pinned")
            dev_id, bd, t = cluster.assign_at(cm.gemm_cost(64, 64, 64, 2),
                                              "pinned-batch")
            log.append(("assign_at", dev_id, dataclasses.astuple(bd),
                        _ticket(t)))
        moved = cluster.fail_device(1)
        log.append(("fail_device", [(_ticket(t), d) for t, d in moved]))
        log.append(("state", _state(cluster)))
        log.append(("restage", dataclasses.astuple(cluster.restage_handle(w)),
                    w.device_id))
        # A pin on a failed device raises, and so does a pin whose device
        # fails inside its scope.
        with pytest.raises(RuntimeError, match="failed"):
            with cluster.pin_device(1):
                pass
        with pytest.raises(RuntimeError, match="mid-scope"):
            with cluster.pin_device(0):
                cluster.fail_device(0)
                launch(8, 8, 8, "after-loss")
        cluster.restore_device(0)
        cluster.restore_device(1)
        log.append(("state", _state(cluster)))
        for i in range(4):
            launch(64 * (i + 1), 64, 64, f"r{i}")
        log.append(("grow", cluster.resize(5)))
        for i in range(5):
            launch(128, 64 * (i + 1), 64, f"s{i}")
        h4 = cluster.pin_handle("kv4", 1.0e6, device_id=4)
        log.append(("shrink", cluster.resize(2), h4.device_id))
        log.append(("state", _state(cluster)))
        dev_id, bd = cluster.assign(cm.gemm_cost(8, 8, 8, 2), "after",
                                    handle=kv)
        log.append(("assign", dev_id, dataclasses.astuple(bd)))
        with pytest.raises(RuntimeError, match="restage to failed"):
            cluster.fail_device(1)
            cluster.restage_handle(kv, device_id=1)
    log.append(("records", [_record(r) for r in trace.records]))
    log.append(("state", _state(cluster)))
    return log


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_cluster_sequence_matches_reference(scheduler):
    got, want = _scenario(PORT, scheduler), _scenario(REF, scheduler)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    kinds = {t[8] for step in want if step[0] == "state"
             for dev in step[1][0] for t in dev[4]}
    assert {"launch", "requeue", "restage"} <= kinds


def _supervised(pkg, scheduler):
    hero, cm, ft = pkg["hero"], pkg["cm"], pkg["ft"]
    cluster = hero.HeroCluster(num_devices=4,
                               platform=pkg["platform"]("tpu-v5e"),
                               scheduler=scheduler)
    cluster.policy = dataclasses.replace(cluster.policy, mode="device")
    clock = _Clock()
    sup = ft.ClusterSupervisor(cluster, timeout_s=5.0, clock=clock)
    for i in range(8):
        cluster.launch(cm.gemm_cost(32 * (i + 1), 64, 64, 4),
                       dtype="float32", shape_key=f"op{i}")
    cluster.pin_handle("kv", 2.0e6, device_id=2)
    cluster.pin_handle("w", 4.0e6, device_id=3)
    clock.t = 4.0
    for d in (0, 1, 3):
        sup.beat(d)
    clock.t = 7.0
    out = []
    for ev in sup.poll():
        out.append((ev.device_id,
                    [(_ticket(t), d) for t, d in ev.rescheduled],
                    ev.evicted_buffers, ev.total_loss, ev.unstaged_handles,
                    ev.restaged))
    out.append(sup.silent_devices())
    sup.recover(2)
    out.append(_state(cluster))
    ev = pkg["elastic"].resize_cluster(cluster, 2, supervisor=sup)
    out.append((ev.before, ev.after, ev.restaged, sorted(sup._last)))
    ev = pkg["elastic"].resize_cluster(cluster, 3, supervisor=sup)
    out.append((ev.before, ev.after, ev.restaged, sorted(sup._last)))
    # Losing every device is reported, not raised.
    for d in (0, 1):
        e = sup.fail_device(d)
        out.append((e.device_id, e.total_loss, e.unstaged_handles,
                    e.restaged))
    last = sup.fail_device(2)
    out.append((last.total_loss, last.rescheduled, last.unstaged_handles))
    out.append(_state(cluster))
    return out


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_supervisor_poll_recover_resize_match_reference(scheduler):
    got, want = _supervised(PORT, scheduler), _supervised(REF, scheduler)
    assert got == want
    assert want[0][0] == 2 and want[0][5]           # kv re-staged on loss


def test_pin_device_is_not_used_for_failure_rescheduling():
    """``fail_device`` re-places orphans over the survivors through the
    scheduler even inside a pin on a survivor."""
    cluster = thero.HeroCluster(num_devices=3, scheduler="round-robin",
                                platform=tplatform("tpu-v5e"))
    cluster.policy = dataclasses.replace(cluster.policy, mode="device")
    for i in range(3):
        cluster.launch(tcm.gemm_cost(64, 64, 64, 4), dtype="float32",
                       shape_key=f"g{i}")
    with cluster.pin_device(1):
        moved = cluster.fail_device(0)
    # round-robin's fourth pick over the survivors [1, 2], not the pin
    assert [d for _, d in moved] == [2]


def test_requeue_is_traced_and_counted():
    """``VirtualDevice.requeue`` writes a ``requeue`` ticket span on the
    survivor's compute lane and bumps ``stream.tickets{kind=requeue}``."""
    from repro_torch.obs import metrics, spans

    cluster = thero.HeroCluster(num_devices=2, scheduler="round-robin",
                                platform=tplatform("tpu-v5e"))
    cluster.policy = dataclasses.replace(cluster.policy, mode="device")
    before = metrics.snapshot().get("stream.tickets{kind=requeue}", 0)
    with spans.span_trace("t") as tr:
        cluster.launch(tcm.gemm_cost(64, 64, 64, 4), dtype="float32",
                       shape_key="g")
        cluster.fail_device(0)
    names = [(s.name, s.lane) for s in tr.spans]
    assert ("requeue:gemm", "dev1/compute") in names
    assert metrics.snapshot()["stream.tickets{kind=requeue}"] == before + 1


def _recovering(ft):
    state = {"saved": 0, "failed": set()}

    def step_fn(step):
        if step in (7, 13) and step not in state["failed"]:
            state["failed"].add(step)
            raise ft.WorkerFailure(f"injected at {step}")
        return {"loss": 1.0 / (step + 1)}, 0.01

    def save_fn(step):
        state["saved"] = step

    def restore_fn():
        return state["saved"]

    return ft.run_with_recovery(num_steps=20, start_step=0, step_fn=step_fn,
                                save_fn=save_fn, restore_fn=restore_fn,
                                checkpoint_every=5)


def test_run_with_recovery_matches_reference():
    got, want = _recovering(tft), _recovering(jft)
    assert got == want
    assert got[0] == 20 and got[2] == 2


def test_heartbeat_and_straggler_monitors_match_reference():
    out = []
    for ft in (tft, jft):
        clock = _Clock()
        hb = ft.HeartbeatMonitor(num_hosts=3, timeout_s=2.0, clock=clock)
        clock.t = 1.5
        hb.beat(0)
        clock.t = 3.0
        sm = ft.StragglerMonitor(num_hosts=3, window=4, threshold=1.5)
        for h, ts in enumerate([(1.0, 1.1, 0.9), (1.0, 1.0, 1.2),
                                (2.5, 2.4, 2.6)]):
            for t in ts:
                sm.record(h, t)
        out.append((hb.failed_hosts(), hb.healthy(), sm.medians(),
                    sm.stragglers()))
    assert out[0] == out[1]
    assert out[0][0] == [1, 2] and out[0][3] == [2]


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m", "paper-gemm"])
def test_costing_matches_reference(arch):
    from repro.configs import get_arch as jget_arch
    from repro.launch import costing as jcosting
    from repro_torch.configs import get_arch as tget_arch
    from repro_torch.launch import costing as tcosting

    assert tcosting.__all__ == jcosting.__all__
    assert tcosting.ITEMSIZE == jcosting.ITEMSIZE
    for reduced in (False, True):
        jc, tc = jget_arch(arch), tget_arch(arch)
        if reduced:
            jc, tc = jc.reduced(), tc.reduced()
        for fn, args, kw in [
                ("stack_gemm_cost", (37,), {"op": "x"}),
                ("prefill_cost", (128,), {}),
                ("decode_cost", (64, 3.5e6), {}),
                ("decode_step_cost", (8,), {"cache_bytes": 2.0e6}),
                ("decode_step_cost", (0,), {})]:
            got = getattr(tcosting, fn)(*args, tc, **kw)
            want = getattr(jcosting, fn)(*args, jc, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), fn
        for fn in ("kv_bytes_per_token", "weight_bytes"):
            assert getattr(tcosting, fn)(tc) == getattr(jcosting, fn)(jc)
        for cost in (tcosting.prefill_cost(256, tc),
                     tcosting.decode_step_cost(4, tc)):
            want = jcosting.weight_resident_fraction(
                jcm.OpCost(**dataclasses.asdict(cost)), jc)
            assert tcosting.weight_resident_fraction(cost, tc) == want
        assert tcosting.weight_resident_fraction(
            tcm.OpCost("z", 0.0, 0.0, 0.0), tc) == 0.0


# ---------------------------------------------------------------------------
# serve_cluster
# ---------------------------------------------------------------------------

class _BlockingJax:
    """``jax`` as the reference's serve module sees it, with every jitted
    step waited for before it returns (the reference's ``_run_prefill``
    rewrites a numpy token buffer that an asynchronously dispatched step may
    still read; see ``tests/test_torch_serve.py``)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        step = jax.jit(fn, **kwargs)
        return lambda *args: jax.block_until_ready(step(*args))


# (scheduler, pin_caches, devices, batches).  Round-robin with three batches
# over two devices sends batch 0's and batch 2's decode away from their
# caches (a d2d migration when pinned, a host re-stage when not).  The
# load-aware schedulers see each lane's queued seconds, which in the port
# include one ticket per eager per-layer launch and in the reference only
# the launches of its one jit trace (ROADMAP, "Deliberate departures"): with
# more batches than devices their placements may differ, so cost-aware runs
# one batch a device.
SERVE_CASES = [("cost-aware", True, 3, 3), ("round-robin", True, 2, 3),
               ("round-robin", False, 2, 3)]


def _serve_cluster_pair(arch, scheduler, pin, devices, nbatches, monkeypatch):
    import repro.launch.serve
    from repro.configs import get_arch as jget_arch
    from repro.launch.serve import serve_cluster as jserve_cluster
    from repro.models import build_model as jbuild
    from repro_torch.convert import params_from_jax
    from repro_torch.core.hero import offload_policy as tpolicy
    from repro_torch.launch.serve import serve_cluster as tserve_cluster

    monkeypatch.setattr(repro.launch.serve, "jax", _BlockingJax())
    seed = 3
    jp = jbuild(jget_arch(arch).reduced()).init_params(
        jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    batches = [[list(map(int, rng.integers(1, 200, size=3 + (b + i) % 3)))
                for i in range(8)] for b in range(nbatches)]
    kw = dict(smoke=True, max_new_tokens=3, cache_len=16, seed=seed,
              pin_caches=pin)
    pol = dict(mode="device", platform="tpu-v5e", num_devices=devices,
               scheduler=scheduler)
    with jhero.offload_policy(**pol, use_pallas=True, interpret=True), \
            jacct.offload_trace() as jt:
        want = jserve_cluster(arch, batches, **kw)
    with tpolicy(**pol, use_kernels=True), tacct.offload_trace() as tt:
        got = tserve_cluster(arch, batches, params=tp, device="cpu", **kw)
    return got, want, jt, tt


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m"])
@pytest.mark.parametrize("scheduler,pin,devices,nbatches", SERVE_CASES)
def test_serve_cluster_matches_reference(arch, scheduler, pin, devices,
                                         nbatches, monkeypatch):
    got, want, jt, tt = _serve_cluster_pair(arch, scheduler, pin, devices,
                                            nbatches, monkeypatch)
    rel = 1e-12
    assert got.placements == want.placements
    assert got.prefill_placements == want.prefill_placements
    assert got.cache_devices == want.cache_devices
    assert got.per_device_s.keys() == want.per_device_s.keys()
    for d, s in want.per_device_s.items():
        assert got.per_device_s[d] == pytest.approx(s, rel=rel)
    for key in ("makespan_s", "tokens_per_s", "d2d_s", "restage_s"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=rel, abs=0.0), key
    assert got.total_tokens == want.total_tokens
    for g, w in zip(got.results, want.results, strict=True):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    # The batch-level moves and their records match one to one.
    moves = ("d2d_copy", "restage")
    assert ([_record(r) for r in tt.records if r.op in moves]
            == [_record(r) for r in jt.records if r.op in moves])
    if scheduler == "cost-aware":
        assert got.placements == got.cache_devices
        assert got.d2d_s == 0.0 and got.restage_s == 0.0
    elif pin:
        assert got.d2d_s > 0.0 and got.restage_s == 0.0
    else:
        assert got.restage_s > 0.0 and got.cache_devices == [-1] * nbatches


def test_serve_cluster_load_aware_departure(monkeypatch):
    """With more batches than devices a load-aware scheduler places by the
    lanes' queued seconds.  The port's eager steps leave one ticket per
    per-layer launch on every lane that ran a prefill, so lanes 0 and 1
    tie and batch 2 goes to lane 0; the reference's jit issues the
    launches of one trace only, on batch 0's lane, which sends batch 2 to
    lane 1.  Lane seconds stay the batch costs of each placement."""
    got, want, _, _ = _serve_cluster_pair("yi-6b", "cost-aware", True, 2, 3,
                                          monkeypatch)
    assert got.prefill_placements == [0, 1, 0]
    assert want.prefill_placements == [0, 1, 1]
    assert got.placements == got.cache_devices == [0, 1, 0]
    assert got.d2d_s == 0.0 == want.d2d_s
    for g, w in zip(got.results, want.results, strict=True):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_serve_cluster_pins_every_launch_to_its_lane():
    """Under ``pin_device`` every per-layer record of a batch's prefill
    and decode carries that batch's lane."""
    from repro_torch.core.hero import offload_policy as tpolicy
    from repro_torch.launch.serve import serve_cluster as tserve_cluster

    batches = [[[5, 6, 7]] * 8, [[9, 10, 11, 12]] * 8]
    with tpolicy(mode="device", platform="tpu-v5e", num_devices=2,
                 scheduler="round-robin"), tacct.offload_trace() as tt:
        res = tserve_cluster("yi-6b", batches, max_new_tokens=2, cache_len=8,
                             device="cpu")
    lanes = [r.device_id for r in tt.records
             if r.op in ("gemm", "qkv_project", "mlp_block", "attention")]
    # prefill b0 (3 steps) on lane 0, b1 (4 steps) on lane 1; decode b0
    # (2 steps) on lane 0, b1 on lane 1.
    per_step = 4 * 2 + 1
    want = ([res.prefill_placements[0]] * 3 * per_step
            + [res.prefill_placements[1]] * 4 * per_step
            + [res.placements[0]] * 2 * per_step
            + [res.placements[1]] * 2 * per_step)
    assert lanes == want and set(lanes) == {0, 1}


def test_cache_nbytes_matches_reference_leaves():
    """The pinned handle's bytes: the port's cache dict against the
    reference's cache pytree, dense (incl. a sliding window shorter than
    the cache) and SSM."""
    from repro.configs import get_arch as jget_arch
    from repro.launch.serve import _cache_nbytes as jbytes
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_arch as tget_arch
    from repro_torch.launch.serve import _cache_nbytes as tbytes
    from repro_torch.models import build_model as tbuild

    for arch, window in [("yi-6b", None), ("yi-6b", 8), ("mamba2-370m", None)]:
        jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
        if window:
            jc = dataclasses.replace(jc, sliding_window=window)
            tc = dataclasses.replace(tc, sliding_window=window)
        for bsz, cache_len in [(8, 16), (3, 64)]:
            want = jbytes(jbuild(jc).init_decode_cache(bsz, cache_len))
            got = tbytes(tbuild(tc).init_decode_cache(bsz, cache_len,
                                                      device="cpu"))
            assert got == want, (arch, window, bsz, cache_len)


def test_cluster_cli_prints_one_modeled_line(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "yi-6b", "--device", "cpu", "--prompt-len", "2",
          "--max-new", "1", "--devices", "2", "--num-batches", "2",
          "--scheduler", "round-robin", "--no-pin-caches"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert out[0].startswith("2 batches over 2 devices (round-robin): "
                             "prefill=[0, 1] decode=[0, 1]")
    assert out[0].endswith("tok/s (modeled)") and "restage=0s" not in out[0]
