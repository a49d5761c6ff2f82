"""The port's phase profiler (``obs/phases.py``) against the JAX package's.

- ``render_phase_table`` byte-equal to JAX's on the same records;
  ``PhaseReport.records()`` equal to JAX's (keys and values) for the
  same fields; ``roofline_classify`` JAX's answer on a grid of inputs
  far from either ridge, and the H100's own ridge (989e12 / 3.35e12)
  where they part; the interval union equal to JAX ``_parse_trace``'s on
  nested and overlapping events written as a JAX trace (exactly: the
  same float sums in the same order).
- Every JAX ``ValueError`` restriction raises in the port.
- The port's segmented step against its fused step, within ``PARITY_*``
  (fp32: rtol 1e-5, atol 1e-6, loss rtol 1e-6), for the JAX suite's
  configurations (``tests/test_profiling.py:116-175``) and DDP and the
  overlapped allreduce, at a world of one (zero1 raises there) and on 4
  Gloo ranks (one launch of 4 processes); ``profile_phases`` restores
  the trainer bitwise.
- The port's segmented step against JAX's ``segmented_step`` from the
  same weights (``models/convert.py``), augmentation off: CIFAR tiny_cnn
  fp32, loss rtol 1e-5, parameters rtol 1e-5 atol 1e-6 (the convolutions
  sum in another order); the LM with JAX's flash and fused_xent in
  interpret mode (dense and dropless MoE), loss rtol 1e-5, parameters as
  ``test_torch_port_lm.py`` holds one AdamW step (within lr = 1e-3, mean
  1e-6, at most one element in 10,000 beyond 1e-5: Adam's first step is
  lr times a gradient's sign, which flips for a gradient at fp32
  rounding level).
- One retake decision for all ranks: on 2 Gloo ranks with the card's
  hooks stubbed and only rank 1's traces empty, ``capture_device_profile``
  under ``world_agree`` retakes and falls back to CUDA events on both
  ranks together (``fn`` an all-reduce; the test's own timeout bounds it),
  and ``_profile`` passes that agreement; the ViT (no batch statistics)
  segments compose to its fused step exactly, dense under DDP and flash
  under ring with dropout.
- ``segment_costs`` counts a product's FLOPs and bytes and adds a
  kernel's reported costs; ``capture_device_profile`` and
  ``device_op_breakdown`` on the CPU (no device lanes: the wall clock);
  ``python -m ...obs report`` renders the bench's records.
"""

import gzip
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.obs import phases as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
BATCH = 32  # 8 a rank on 4 ranks
TINY = dict(model="tiny_cnn", global_batch_size=BATCH, synthetic_data=True,
            compute_dtype="float32", device="cpu")
# The JAX suite's cases, plus DDP and the overlapped float allreduce.
CONFIGS = {
    "allreduce": dict(sync="allreduce"),
    "allreduce-perleaf": dict(sync="allreduce", sync_bucket_mb=0),
    "ring": dict(sync="ring"),
    "int8": dict(sync="allreduce", grad_compress="int8"),
    "zero1": dict(sync="zero1"),
    "zero1-overlap": dict(sync="zero1", sync_overlap="bucket"),
    "zero1-int8": dict(sync="zero1", grad_compress="int8", sync_overlap="bucket+int8"),
    "auto": dict(sync="auto"),
    "allreduce-overlap": dict(sync="allreduce", sync_overlap="bucket"),
}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(rank: int, world: int):
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10

    ds = synthetic_cifar10(BATCH, 8, seed=0)
    per = BATCH // world
    rows = slice(rank * per, (rank + 1) * per)
    return (torch.from_numpy(ds.train_images[rows]),
            torch.from_numpy(ds.train_labels[rows].astype(np.int64)))


def _trainer(world: int, **kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    return Trainer(TrainConfig(**TINY, num_devices=world, **kw))


def _parity(tr, x, y) -> dict:
    """The fused and the segmented step from one state: this rank's
    losses, whether the parameters agree within PARITY_*, the largest gap."""
    segs = P.build_cifar_segments(tr)
    start = tr.capture_state(clone=True)
    loss_f = float(segs.fused(x, y))
    params_f = [p.detach().clone() for p in tr.state.params]
    tr.restore_state(start)
    loss_s = float(segs.segmented_step(x, y))
    params_s = [p.detach() for p in tr.state.params]
    close = all(torch.allclose(a, b, rtol=P.PARITY_RTOL, atol=P.PARITY_ATOL)
                for a, b in zip(params_f, params_s))
    gap = max(float((a - b).abs().max()) for a, b in zip(params_f, params_s))
    return {"loss_fused": loss_f, "loss_segmented": loss_s, "params_close": close, "gap": gap,
            "step": tr.state.step}


def _states_equal(a: dict, b: dict) -> bool:
    pairs = [(u, v) for key in ("params", "momentum", "ef", "opt_nu")
             for u, v in zip(a[key], b[key], strict=True)]
    pairs += [(a["buffers"][n], b["buffers"][n]) for n in a["buffers"]]
    return (a["step"] == b["step"] and torch.equal(a["augment_gen"], b["augment_gen"])
            and all(torch.equal(u, v) for u, v in pairs))


def _profile_case(tr, x, y) -> dict:
    before = tr.capture_state(clone=True)
    report = P.profile_phases(tr, x, y, iters=1)
    return {
        "parity_ok": report.parity_ok,
        "names": [p.name for p in report.phases],
        "sync_comm_bytes": report.phase("grad_sync").comm_bytes,
        "sync_roofline": report.phase("grad_sync").roofline,
        "n_chips": report.n_chips,
        "restored": _states_equal(before, tr.capture_state()),
        "table": report.table(),
    }


def _worker(rank: int, port: int, out_path: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        x, y = _batch(rank, WORLD)
        res = {name: _parity(_trainer(WORLD, **kw), x, y) for name, kw in CONFIGS.items()}
        res["profile"] = _profile_case(_trainer(WORLD, sync="allreduce"), x, y)
        with open(out_path, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("phases_dp4")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp / f"r{r}.json")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [json.loads((tmp / f"r{r}.json").read_text()) for r in range(WORLD)]


def _assert_parity(res: dict) -> None:
    assert res["params_close"], res
    assert abs(res["loss_segmented"] - res["loss_fused"]) <= P.PARITY_LOSS_RTOL * max(
        1.0, abs(res["loss_fused"])), res
    assert res["step"] == 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_segmented_equals_fused_on_four_ranks(four_ranks, name):
    for rank, res in enumerate(four_ranks):
        _assert_parity(res[name])
    if name in ("ring", "zero1", "zero1-overlap"):  # the same arithmetic, one order
        assert all(res[name]["gap"] == 0.0 for res in four_ranks)


def test_profile_phases_on_four_ranks(four_ranks):
    for res in four_ranks:
        prof = res["profile"]
        assert prof["parity_ok"] and prof["restored"] and prof["n_chips"] == WORLD
        assert tuple(prof["names"]) == P.PHASE_NAMES
        assert prof["sync_comm_bytes"] > 0 and prof["sync_roofline"] == "comms"
        assert "grad_sync" in prof["table"] and "sync_exposed_ms" in prof["table"]


# ------------------------------------------------------------ a world of one
@pytest.fixture
def gloo_world_of_one():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["allreduce", "allreduce-perleaf", "ring", "int8", "auto",
                                  "allreduce-overlap"])
def test_segmented_equals_fused_at_a_world_of_one(gloo_world_of_one, name):
    x, y = _batch(0, 1)
    res = _parity(_trainer(1, **CONFIGS[name]), x, y)
    _assert_parity(res)
    assert res["gap"] == 0.0  # one rank: the mean is the gradient itself


def test_segmented_equals_fused_without_a_process_group():
    """part 1 (sync 'none', no process group): no sync program, the
    phase untimed, the step bitwise."""
    x, y = _batch(0, 1)
    tr = _trainer(1, sync="none")
    assert P.build_cifar_segments(tr).sync is None
    res = _parity(tr, x, y)
    assert res["gap"] == 0.0 and res["loss_fused"] == res["loss_segmented"]
    report = P.profile_phases(tr, x, y, iters=1)
    sync = report.phase("grad_sync")
    assert report.parity_ok and sync.wall_ms == 0.0 and sync.flops is None


@pytest.mark.parametrize("overrides,match", [
    (dict(sync="allreduce", accum_steps=2), "accum_steps"),
    (dict(sync="fsdp"), "fsdp"),
    (dict(sync="allreduce", fused_optimizer=True), "fused_optimizer"),
    (dict(sync="zero1"), "bucket"),  # a world of one: no bucket lanes
    (dict(sync="zero1", sync_bucket_mb=0), "bucket"),
])
def test_cifar_segments_raise_jax_restrictions(gloo_world_of_one, overrides, match):
    tr = _trainer(1, **overrides)
    with pytest.raises(ValueError, match=match):
        P.build_cifar_segments(tr)
    with pytest.raises(ValueError, match=match):
        P.profile_phases(tr, *_batch(0, 1))


def test_profile_phases_end_to_end_restores_the_trainer(gloo_world_of_one):
    x, y = _batch(0, 1)
    tr = _trainer(1, sync="allreduce", augment=True)
    tr.train_step(x, y)  # gradients, BatchNorm statistics and the generator moved
    grads = [p.grad for p in tr.params]
    before = tr.capture_state(clone=True)
    report = P.profile_phases(tr, x, y, iters=2)
    assert _states_equal(before, tr.capture_state())
    assert all(p.grad is g for p, g in zip(tr.params, grads))
    assert report.parity_ok and report.n_chips == 1 and report.iters == 2
    assert tuple(p.name for p in report.phases) == P.PHASE_NAMES
    assert all(p.clock == "wall" and p.device_ms == 0.0 for p in report.phases)
    fwd = report.phase("forward")
    assert fwd.flops > 0 and fwd.bytes_accessed > 0 and fwd.mfu is None
    assert report.device_kind == "cpu" and report.sync_exposed_ms >= 0.0
    records = report.records(run="test")
    assert len(P.phase_records_from_stream(records)) == len(P.PHASE_NAMES) + 1
    assert "grad_sync" in P.render_phase_table(records)


# ------------------------------------------------------------ against JAX
def test_cifar_segmented_step_matches_jax(gloo_world_of_one):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.obs import phases as JP
    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.parallel.mesh import shard_global_batch
    from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
        jax_from_state_dict,
        state_dict_from_jax,
    )

    kw = dict(model="tiny_cnn", num_devices=1, global_batch_size=BATCH, synthetic_data=True,
              compute_dtype="float32", sync="allreduce", augment=False, learning_rate=0.05)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtr = JaxTrainer(JaxConfig(**kw), mesh=mesh)
    state = jtr.init()
    ds = synthetic_cifar10(BATCH, 8, seed=0)
    jx, jy = shard_global_batch(mesh, ds.train_images, ds.train_labels)
    new, loss = JP.build_cifar_segments(jtr).segmented_step(state, jx, jy, jax.random.key(0))
    init = {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(lambda a: np.asarray(a)[0], state.batch_stats)}

    tr = _trainer(1, **{k: v for k, v in kw.items() if k not in TINY and k != "num_devices"})
    tr.model.load_state_dict(state_dict_from_jax(init, "tiny_cnn"))
    got = float(P.build_cifar_segments(tr).segmented_step(*_batch(0, 1)))
    assert got == pytest.approx(float(loss), rel=1e-5)
    port = jax_from_state_dict(tr.model.state_dict(), "tiny_cnn")["params"]
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(jax.tree.map(np.asarray, new.params)),
                    strict=True):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-6)


LM_SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=64, d_ff=128, max_seq_len=32,
                seq_len=32, global_batch_size=4, use_rope=True, learning_rate=1e-3,
                attention_impl="flash", fused_xent=True)
LM_CASES = {"dense": {}, "moe": dict(moe_experts=4, moe_top_k=2, moe_dispatch="dropless",
                                     moe_gmm_impl="pallas")}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_segmented_step_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.obs import phases as JP
    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    kw = {**LM_SMALL, **LM_CASES[case]}
    jt = JaxTrainer(JaxConfig(**kw), mesh=make_mesh({"data": 1, "seq": 1},
                                                     devices=jax.devices()[:1]))
    params, opt = jt.init()
    toks = synthetic_tokens(4, 32, 64, seed=3)
    (new, _), loss = JP.build_lm_segments(jt).segmented_step(params, opt, *jt.shard_batch(toks),
                                                             jnp.int32(0))
    port = LMTrainer(LMConfig(**kw, device="cpu"))
    port.init(state_dict=lm_params_from_jax(jax.device_get(params)))
    segs = P.build_lm_segments(port)
    assert segs.sync is None
    got = float(segs.segmented_step(*port.split_batch(toks)))
    assert got == pytest.approx(float(loss), rel=1e-5)
    want = lm_params_from_jax(jax.device_get(new))
    errs = torch.cat([(want[k] - v).abs().flatten() for k, v in port.model.state_dict().items()])
    assert float(errs.max()) <= LM_SMALL["learning_rate"] and float(errs.mean()) <= 1e-6
    assert int((errs > 1e-5).sum()) <= 1e-4 * errs.numel()


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_segmented_equals_fused_and_profiles(case):
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**LM_SMALL, **LM_CASES[case], device="cpu"))
    tr.init()
    x, y = tr.split_batch(synthetic_tokens(4, 32, 64, seed=3))
    before = tr.capture_state(clone=True)
    report = P.profile_lm_phases(tr, x, y, iters=1)
    after = tr.capture_state()
    assert all(torch.equal(a, b) for key in ("params", "momentum", "opt_nu")
               for a, b in zip(before[key], after[key], strict=True))
    assert (after["step"], after["opt_count"]) == (before["step"], before["opt_count"])
    assert report.parity_ok and report.max_param_abs_diff == 0.0
    assert report.loss_fused == report.loss_segmented
    sync = report.phase("grad_sync")
    assert (sync.wall_ms, sync.device_ms, sync.comm_bytes) == (0.0, 0.0, 0.0)
    assert report.phase("forward").flops > 0


@pytest.mark.parametrize("field,value,match", [
    ("accum_steps", 2, "accum_steps"),
    ("zero1", True, "zero1"),
    ("fsdp", True, "fsdp"),
    ("seq_parallel", 2, "data-parallel"),
    ("tensor_parallel", 2, "data-parallel"),
    ("moe_expert_parallel", True, "data-parallel"),
])
def test_lm_segments_raise_jax_restrictions(field, value, match):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**LM_SMALL, device="cpu"))
    tr.init()
    tr.cfg = tr.cfg.replace(**{field: value})  # past the config check, which refuses them
    with pytest.raises(ValueError, match=match):
        P.build_lm_segments(tr)


# ------------------------------------------------------------ the report
def _records(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    stats = [P.PhaseStat(name, float(rng.random() * 10) if clock == "device" else 0.0,
                         float(rng.random() * 10), clock,
                         None if name == "grad_sync" else float(rng.random() * 1e12),
                         float(rng.random() * 1e9), 0.0 if name != "grad_sync" else 4096.0,
                         None if clock == "wall" else float(rng.random()), "memory")
             for name, clock in zip(P.PHASE_NAMES, ("device", "device", "wall", "device"))]
    return P.PhaseReport(stats, 12.5, "device", 11.25, 0.0, bool(seed % 2), 2.25, 2.25, 0.0, 1,
                         "NVIDIA H100 80GB HBM3", 4096, 3).records(run="bench_resnet18")


@pytest.mark.parametrize("seed", [0, 1])
def test_records_and_table_equal_jax(seed):
    from cs744_pytorch_distributed_tutorial_tpu.obs import phases as JP

    port = _records(seed)
    jstats = [JP.PhaseStat(r["phase"], r["device_ms"], r["wall_ms"], r["clock"], r["flops"],
                           r["bytes_accessed"], r["comm_bytes"], r["mfu"], r["roofline"])
              for r in port[:-1]]
    s = port[-1]
    jax_recs = JP.PhaseReport(jstats, s["fused_step_ms"], s["fused_clock"],
                              s["segmented_total_ms"], s["sync_exposed_ms"], s["parity_ok"],
                              s["loss_fused"], s["loss_segmented"], s["max_param_abs_diff"],
                              s["n_chips"], s["device_kind"], s["batch"],
                              s["iters"]).records(run="bench_resnet18")
    assert [set(r) for r in port] == [set(r) for r in jax_recs]
    assert port == jax_recs
    mixed = [{"kind": "step", "loss": 1.0}, *port, {"kind": "bench", "value": 3.0}]
    assert P.render_phase_table(mixed) == JP.render_phase_table(mixed)
    assert P.render_phase_table([]) == JP.render_phase_table([]) == "(no phase records)"
    assert P.phase_records_from_stream(mixed) == JP.phase_records_from_stream(mixed)


def test_roofline_matches_jax_and_takes_the_h100_ridge():
    from cs744_pytorch_distributed_tutorial_tpu.obs import phases as JP

    values = (None, 0.0, 1e3, 1e6, 1e9, 1e12)
    for kind in (None, "cpu", "TPU v5 lite", "unknown accelerator"):
        for flops in values:
            for nbytes in values:
                for comm in (0.0, 1024.0):
                    assert (P.roofline_classify(flops, nbytes, kind, comm_bytes=comm)
                            == JP.roofline_classify(flops, nbytes, kind, comm_bytes=comm))
    h100 = "NVIDIA H100 80GB HBM3"
    assert 989e12 / 3.35e12 == pytest.approx(295.2, abs=0.1)
    assert P.roofline_classify(270e9, 1e9, h100) == "memory"  # JAX's default ridge: compute
    assert P.roofline_classify(270e9, 1e9, None) == "compute"
    assert P.roofline_classify(300e9, 1e9, h100) == "compute"


def _fake_events(seed: int):
    """Nested and overlapping (start, dur) intervals on two device lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for lane in (0, 1):
        t = 0.0
        for i in range(30):
            t += float(rng.integers(0, 40))
            dur = float(rng.integers(1, 60))
            out.append((lane, f"op{i % 7}", t, dur))
            if i % 4 == 0:  # a child nested at its parent's start
                out.append((lane, "child", t, float(rng.integers(1, int(dur) + 1))))
            if i % 5 == 0:  # straddling the next parent's start
                out.append((lane, "dma", t + dur / 2, dur))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_union_equals_jax_parse_trace(tmp_path, seed):
    from cs744_pytorch_distributed_tutorial_tpu.obs import phases as JP

    evs = _fake_events(seed)
    trace = {"traceEvents": [
        *[{"ph": "M", "name": "process_name", "pid": lane, "args": {"name": f"/device:TPU:{lane}"}}
          for lane in (0, 1)],
        *[{"ph": "X", "pid": lane, "tid": 0, "name": name, "ts": ts, "dur": dur}
          for lane, name, ts, dur in evs],
    ]}
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    want_ms, want_rows = JP._parse_trace(str(tmp_path), 3, 5)
    events = [types.SimpleNamespace(name=name, device_index=lane,
                                    time_range=types.SimpleNamespace(
                                        start=ts, elapsed_us=lambda dur=dur: dur))
              for lane, name, ts, dur in evs]
    got_ms, got_rows = P._parse_events(events, 3, 5)
    assert got_ms == want_ms and got_rows == want_rows
    assert P._interval_union_us([(0.0, 10.0), (2.0, 3.0), (8.0, 6.0), (20.0, 1.0)]) == 15.0


# ------------------------------------------------------------ costs and capture
def test_segment_costs_count_products_bytes_and_kernels():
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost

    a, b = torch.ones(8, 16), torch.ones(16, 4)

    def fn(a, b):
        _cost.add(1e6, 2e3)  # a hand-written kernel's report
        return (a @ b).view(-1)  # the view moves nothing

    costs = P.segment_costs(fn, a, b)
    assert costs["flops"] == 2 * 8 * 16 * 4 + 1e6
    assert costs["bytes_accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 2e3
    with _cost.counting() as outer:
        P.segment_costs(fn, a, b)
    assert (outer.flops, outer.bytes_accessed) == (1e6, 2e3)


def test_capture_device_profile_and_breakdown_on_cpu(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.profiling import device_op_breakdown

    a = torch.ones(64, 64)
    prof = P.capture_device_profile(lambda t: t @ t, a, iters=2, trace_dir=str(tmp_path))
    assert prof.device_ms == 0.0 and prof.clock == "wall" and prof.best_ms() == prof.wall_ms
    assert prof.wall_ms > 0 and prof.op_rows == [] and prof.iters == 2
    assert len(list(tmp_path.glob("phases_*.json"))) == 1
    assert device_op_breakdown(lambda t: t.sum(), a, iters=1) == (0.0, [])
    with pytest.raises(ValueError, match="iters"):
        P.capture_device_profile(lambda: None, iters=0)


def test_capture_device_profile_times_with_events_when_traces_are_empty(monkeypatch, capsys):
    """On a card, traces without device events are retaken; when every one
    is empty, CUDA events time the calls (clock "events", no op rows), and
    the reports read that time as a card's. The card's hooks are stubbed."""
    calls, timed = [], []
    monkeypatch.setattr(P, "_device_of", lambda *trees: torch.device("cuda", 0))
    monkeypatch.setattr(P, "_fence", lambda device: None)
    monkeypatch.setattr(P, "_device_events", lambda prof: [])
    monkeypatch.setattr(P, "_TRACE_PADS_S", (0.0, 0.0, 0.0))

    def events_ms(fn, args, iters, device):
        timed.append((iters, device))
        for _ in range(iters):
            fn(*args)
        return 1.5

    monkeypatch.setattr(P, "_events_ms", events_ms)
    prof = P.capture_device_profile(lambda t: calls.append(1) or t + 1, torch.ones(4), iters=2)
    # One warm-up, 2 calls in each of the 3 traces, 2 under the events.
    assert len(calls) == 1 + 2 * P._TRACE_ATTEMPTS + 2
    assert timed == [(2, torch.device("cuda", 0))]
    assert (prof.device_ms, prof.op_rows, prof.iters, prof.from_events) == (1.5, [], 2, True)
    assert prof.clock == "events" and prof.best_ms() == 1.5 and prof.clock in P.DEVICE_CLOCKS
    err = capsys.readouterr().err
    assert err.count("holds no device event") == P._TRACE_ATTEMPTS
    assert "timed with CUDA events instead: 1.5000 ms" in err

    traced = P.DeviceProfile(device_ms=4.0, wall_ms=5.0, op_rows=[], iters=2)
    assert traced.clock == "device"
    backward = P._derived_backward(prof, traced, {"flops": 2.0, "bytes_accessed": 2.0},
                                   {"flops": 1.0, "bytes_accessed": 1.0}, "cpu")
    assert backward.clock == "wall"  # 1.5 - 4.0 clamps to 0: no device time left
    backward = P._derived_backward(traced, prof, {"flops": 2.0, "bytes_accessed": 2.0},
                                   {"flops": 1.0, "bytes_accessed": 1.0}, "cpu")
    assert (backward.clock, backward.device_ms) == ("events", 2.5)
    table = P.render_phase_table([{"kind": "phase", "phase": "optimizer", "device_ms": 1.5,
                                   "wall_ms": 9.0, "clock": "events"}])
    assert "1.5" in table and "9.0" not in table


def test_obs_report_renders_the_bench_records(tmp_path, capsys):
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.__main__ import main

    records = _records(0)
    (tmp_path / "phase_report.json").write_text(json.dumps(records))
    assert main(["report", str(tmp_path)]) == 0
    assert capsys.readouterr().out.rstrip("\n") == P.render_phase_table(records)
    stream = tmp_path / "m"
    stream.mkdir()
    (stream / "metrics.jsonl").write_text(
        "\n".join(json.dumps(r) for r in [{"kind": "step"}, *records]) + "\nnot json\n")
    assert main(["report", str(stream / "metrics.jsonl")]) == 0
    assert capsys.readouterr().out.rstrip("\n") == P.render_phase_table(records)
    (stream / "metrics.jsonl").write_text(json.dumps({"kind": "step"}) + "\n")
    assert main(["report", str(stream)]) == 1
    # serve-report is ported (tests/test_torch_port_serve_trace.py): a dir
    # without serve_spans.jsonl is no trace; fleet-report is not ported.
    with pytest.raises(FileNotFoundError, match="serve_spans.jsonl"):
        main(["serve-report", str(tmp_path)])
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["fleet-report", str(tmp_path)])


# ------------------------------------------------------------ one retake decision
def _c1_worker(rank: int, port: int, out_path: str) -> None:
    """Rank ``rank`` of 2 Gloo ranks timing ``fn`` (an all-reduce) with the
    card's hooks stubbed: rank 0's traces hold device events, rank 1's are
    all empty. With the world's agreement both retake together and both
    fall back to the events together; without it, rank 0 would stop after
    its first trace while rank 1 retakes, and rank 1's collectives would
    wait for ever."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        event = types.SimpleNamespace(name="k", device_index=0, time_range=types.SimpleNamespace(
            start=0.0, elapsed_us=lambda: 5.0))
        traces = []
        P._device_of = lambda *trees: torch.device("cuda", 0)
        P._fence = lambda device: None
        P._TRACE_PADS_S = (0.0, 0.0, 0.0)
        P._device_events = lambda prof: traces.append(1) or ([event] if rank == 0 else [])

        def events_ms(fn, args, iters, device):
            for _ in range(iters):
                fn(*args)
            return 2.5

        P._events_ms = events_ms
        calls = []

        def fn(t):
            calls.append(1)
            dist.all_reduce(t)
            return t

        prof = P.capture_device_profile(fn, torch.ones(4), iters=2, agree=P.world_agree)
        with open(out_path, "w") as f:
            json.dump({"clock": prof.clock, "device_ms": prof.device_ms, "traces": len(traces),
                       "calls": len(calls)}, f)
    finally:
        dist.destroy_process_group()


def test_every_rank_takes_one_retake_decision(tmp_path):
    """C1: two Gloo ranks, only rank 1's traces empty, ``fn`` an
    all-reduce. Both ranks finish under this test's own timeout, on the
    same clock after the same number of traces and calls."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "c1", str(r), str(port),
                               str(tmp_path / f"c1_{r}.json")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = [json.loads((tmp_path / f"c1_{r}.json").read_text()) for r in range(2)]
    assert res[0] == res[1], res
    # Three traces, then the events: one warm-up, 2 calls a trace, 2 timed.
    assert res[0] == {"clock": "events", "device_ms": 2.5, "traces": P._TRACE_ATTEMPTS,
                      "calls": 1 + 2 * P._TRACE_ATTEMPTS + 2}
    assert "another rank's trace holds no device event" in logs[0]
    assert logs[1].count("holds no device event") == P._TRACE_ATTEMPTS


def test_profile_passes_the_world_agreement(monkeypatch):
    """``_profile`` hands every capture the world's agreement; the other
    callers (one rank under a group) pass none and decide alone."""
    seen = []
    real = P.capture_device_profile

    def spy(fn, *args, **kw):
        seen.append(kw.get("agree"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(P, "capture_device_profile", spy)
    x, y = _batch(0, 1)
    P.profile_phases(_trainer(1, sync="none"), x, y, iters=1)
    assert seen and all(a is P.world_agree for a in seen)
    assert P.world_agree(True) and not P.world_agree(False)  # no group: this rank alone


# ------------------------------------------------------------ the ViT
@pytest.fixture
def narrow_vit(monkeypatch):
    from cs744_pytorch_distributed_tutorial_tpu_torch import models as PM
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.vit import ViT

    narrow = dict(d_model=32, num_layers=2, num_heads=2, d_ff=64)
    monkeypatch.setitem(PM.MODEL_REGISTRY, "vit_tiny", lambda **kw: ViT(**{**narrow, **kw}))


@pytest.mark.parametrize("overrides", [dict(sync="auto"),
                                       dict(sync="ring", vit_attention="flash",
                                            dropout_rate=0.1)],
                         ids=["auto-dense", "ring-flash-dropout"])
def test_vit_segments_equal_fused(gloo_world_of_one, narrow_vit, overrides):
    """A model without batch statistics: the ViT, dense under DDP (the
    bench's ``--phase-breakdown --model vit_tiny`` default), and flash
    under ring with dropout (the segments draw the step's masks): the
    segmented step is the fused step exactly, and ``profile_phases``
    restores the trainer."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    def vit():
        return Trainer(TrainConfig(**{**TINY, "model": "vit_tiny"}, num_devices=1, **overrides))

    x, y = _batch(0, 1)
    tr = vit()
    assert not list(tr.model.buffers())
    res = _parity(tr, x, y)
    _assert_parity(res)
    assert res["gap"] == 0.0 and res["loss_fused"] == res["loss_segmented"]
    prof = _profile_case(vit(), x, y)
    assert prof["parity_ok"] and prof["restored"]


if __name__ == "__main__":
    if sys.argv[1] == "c1":
        _c1_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
