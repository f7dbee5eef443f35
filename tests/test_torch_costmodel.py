"""The port's measured cost model (ballista_tpu_torch/ops/costmodel.py)
against the JAX package's (ballista_tpu/ops/costmodel.py): the store,
buckets, prediction, forgetting, re-tiering, the mispredict check and
persistence into a temporary directory (the cases of tests/test_costmodel.py
that need no device join), each run through both modules with the same
inputs where the JAX module can take them. The port writes its own file
(costs_torch.json) under its own fingerprint (torch, CUDA, device name), so
it and a JAX store in the same directory both survive each other's flush.
"""

import json

import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.ops import costmodel as jcm
from ballista_tpu.ops import runtime as jr
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.ops import costmodel as tcm
from ballista_tpu_torch.ops import runtime as tr

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""


def _settings(d):
    return {"ballista.tpu.cost_model": "true", "ballista.tpu.cost_model_dir": str(d)}


@pytest.fixture
def cm(tmp_path):
    """Both cost models bound to one throwaway directory."""
    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    tr.routing_stats(reset=True)
    cfg = BallistaConfig(_settings(tmp_path / "costs"))
    tcm.configure(cfg)
    jcm.configure(JaxConfig(_settings(tmp_path / "costs")))
    yield cfg
    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    tr.routing_stats(reset=True)


def test_defaults_and_constants_match_reference():
    assert (tcm._FORMAT, tcm.MIN_OBSERVATIONS, tcm._FORGET_AT, tcm.MISPREDICT_FACTOR) == (
        jcm._FORMAT, jcm.MIN_OBSERVATIONS, jcm._FORGET_AT, jcm.MISPREDICT_FACTOR)
    assert tcm._STORE_BASENAME == "costs_torch.json" != jcm._STORE_BASENAME
    for u in (0, 1, 2, 3, 64, 65, 1000, 1 << 20, (1 << 20) + 1):
        assert tcm._bucket(u) == jcm._bucket(u)
    assert tcm._key("join.gather", "device", 64) == jcm._key("join.gather", "device", 64)


def test_fingerprint_names_the_torch_stack():
    import torch

    fp = tcm._fingerprint()
    assert fp.startswith(f"cm{tcm._FORMAT}|torch={torch.__version__}|")
    assert fp.endswith("|cpu") or torch.cuda.is_available()


def test_store_roundtrip(cm, tmp_path):
    for _ in range(tcm.MIN_OBSERVATIONS):
        tcm.observe("op.x", 1024, 0.010)
    tcm.flush()
    assert (tmp_path / "costs" / "costs_torch.json").exists()
    tcm.reset()  # a fresh process: in-memory store gone, directory kept
    tcm.configure(cm)
    p = tcm.predict("op.x", 1024)
    assert p is not None and abs(p - 0.010) < 1e-9


def test_store_corruption_starts_empty(cm, tmp_path):
    d = tmp_path / "costs"
    d.mkdir(parents=True, exist_ok=True)
    (d / "costs_torch.json").write_text("{definitely not json")
    assert tcm.predict("op.x", 64) is None
    assert tcm.snapshot() == {}
    assert tr.routing_stats(reset=True)["events"].get("cost_store_corrupt") == 1


def test_store_fingerprint_mismatch_ignored(cm, tmp_path):
    d = tmp_path / "costs"
    d.mkdir(parents=True, exist_ok=True)
    (d / "costs_torch.json").write_text(json.dumps({
        "format": tcm._FORMAT, "fingerprint": "cm2|some-other-stack",
        "entries": {"op.x|device|b64": {"s": 1.0, "units": 64, "n": 99}},
    }))
    assert tcm.predict("op.x", 64) is None
    assert tr.routing_stats(reset=True)["events"].get("cost_store_fingerprint_mismatch") == 1


def test_flush_merges_other_writers(cm, tmp_path):
    tcm.seed("ours", 64, 0.001)
    tcm.flush()
    path = tmp_path / "costs" / "costs_torch.json"
    blob = json.loads(path.read_text())
    blob["entries"]["theirs|device|b64"] = {"s": 0.5, "units": 64, "n": 8}
    path.write_text(json.dumps(blob))
    tcm.observe("ours", 64, 0.001)  # dirty again
    tcm.flush()
    merged = json.loads(path.read_text())["entries"]
    assert "theirs|device|b64" in merged and "ours|device|b64" in merged


def test_port_and_jax_stores_share_a_directory(cm, tmp_path):
    """Each package flushes its own file under its own fingerprint: both
    survive the other's flush, and each reloads its own evidence."""
    d = tmp_path / "costs"
    tcm.seed("join.gather", 1 << 20, 0.002)
    jcm.seed("join.gather", 1 << 20, 0.5)
    tcm.flush()
    jcm.flush()
    tcm.seed("join.host", 5000, 0.01, engine="host")
    tcm.flush()
    jcm.seed("join.host", 5000, 0.9, engine="host")
    jcm.flush()
    port_blob = json.loads((d / "costs_torch.json").read_text())
    jax_blob = json.loads((d / "costs.json").read_text())
    assert port_blob["fingerprint"] == tcm._fingerprint() != jax_blob["fingerprint"]
    assert set(port_blob["entries"]) == set(jax_blob["entries"]) == {
        "join.gather|device|b1048576", "join.host|host|b8192"}
    tcm.reset()
    jcm.reset()
    tcm.configure(cm)
    jcm.configure(JaxConfig(_settings(d)))
    assert tcm.predict("join.gather", 1 << 20) == pytest.approx(0.002)
    assert jcm.predict("join.gather", 1 << 20) == pytest.approx(0.5)
    assert tcm.predict("join.host", 5000, engine="host") == pytest.approx(0.01)


def test_cold_predict_is_none(cm):
    assert tcm.predict("never.seen", 1000) is None


def test_exact_bucket_preferred_over_global(cm):
    for mod in (tcm, jcm):
        mod.seed("op.y", 64, 0.001)
        mod.seed("op.y", 4096, 0.400)
    for units in (64, 4096, 1 << 20, 100):
        assert tcm.predict("op.y", units) == pytest.approx(jcm.predict("op.y", units))
    assert tcm.predict("op.y", 64) == pytest.approx(0.001)
    assert tcm.predict("op.y", 4096) == pytest.approx(0.400)


def test_prediction_needs_min_observations(cm):
    tcm.observe("op.z", 128, 0.002)
    assert tcm.predict("op.z", 128) is None


def test_exponential_forgetting_matches_reference(cm):
    for _ in range(200):
        tcm.observe("op.f", 256, 0.001)
        jcm.observe("op.f", 256, 0.001)
    entry = tcm.snapshot()["op.f|device|b256"]
    assert entry["n"] <= 2 * 32 + 1
    assert entry == pytest.approx(jcm.snapshot()["op.f|device|b256"])


def test_retier_replaces_history(cm):
    tcm.seed("op.r", 512, 10.0)
    tcm.retier("op.r", 512, 0.001)
    p = tcm.predict("op.r", 512)
    assert p is not None and p < 0.01
    assert tr.routing_stats(reset=True)["events"].get("retier") == 1


def test_check_mispredict_is_symmetric(cm):
    assert not tcm.check_mispredict("op.c", 64, None, 1.0)
    assert not tcm.check_mispredict("op.c", 64, 0.010, 0.011)
    assert tcm.check_mispredict("op.c", 64, 0.001, 0.010)  # slower
    assert tcm.predict("op.c", 64) == pytest.approx(0.010)
    assert tcm.check_mispredict("op.c", 64, 0.100, 0.002)  # faster
    assert tcm.predict("op.c", 64) == pytest.approx(0.002)
    assert tr.routing_stats(reset=True)["events"].get("retier") == 2
    for pred, obs in ((1.0, 3.0), (1.0, 3.01), (3.0, 1.0), (3.01, 1.0), (1.0, 0.2)):
        assert tcm.gross_mispredict(pred, obs) == jcm.gross_mispredict(pred, obs)


def test_disabled_model_noops():
    tcm.reset(clear_dir=True)
    tcm.observe("op.off", 64, 1.0)
    assert tcm.predict("op.off", 64) is None
    assert tcm.snapshot() == {}


def test_timed_observes_without_retiering(cm):
    with tcm.timed("join.host", 1000, engine="host", predictive=False):
        pass
    assert tcm.snapshot()["join.host|host|b1024"]["n"] == 1
    tr.routing_stats(reset=True)
    for _ in range(tcm.MIN_OBSERVATIONS):
        tcm.observe("op.t", 8, 100.0)
    with tcm.timed("op.t", 8, routing_op="op.t"):
        pass  # predicted 100 s, observed ~0: a mispredict that re-tiers
    s = tr.routing_stats(reset=True)
    assert s["events"] == {"op.t:device": 1, "retier": 1}
    assert s["costs"]["predictions"] == 1 and s["costs"]["mispredicts"] == 1


def test_routing_accounting_sums(cm):
    """Cost totals accumulate only over decisions with both a prediction and
    an observation, as jr.record_routing's do; they are routing events,
    never stage routes."""
    tr.routing_stats(reset=True)
    calls = [("device", "join", 0.010, 0.011), ("device", "join", 0.001, 0.010),
             ("host", "join", 0.030, 0.002), ("split", "join", None, None)]
    jr.routing_stats(reset=True)
    for args in calls:
        tr.record_routing(*args)
        jr.record_routing(*args)
    s, j = tr.routing_stats(reset=True), jr.routing_stats(reset=True)
    assert s["routes"] == {} and s["reasons"] == {}
    assert s["events"] == {"join:device": 2, "join:host": 1, "join:split": 1}
    assert s["costs"]["predictions"] == j["predictions"] == 3
    assert s["costs"]["mispredicts"] == j["mispredicts"] == 2
    assert s["costs"]["predicted_s"] == pytest.approx(j["predicted_s"])
    assert s["costs"]["observed_s"] == pytest.approx(j["observed_s"])


def test_routing_probe_buffers_until_commit():
    tr.routing_stats(reset=True)
    tr.join_path_stats(reset=True)
    with tr.routing_probe():
        tr.record_routing("host", "join")
        tr.record_join_path("step_aside", "why")
        tr.record_routing_event("split")  # events pass through
    assert tr.join_path_stats()["paths"] == {}
    assert tr.routing_stats()["events"] == {"split": 1}
    with tr.routing_probe() as rp:
        tr.record_routing("device", "join")
        tr.record_join_path("device")
    rp.commit()
    assert tr.join_path_stats(reset=True)["paths"] == {"device": 1}
    assert tr.routing_stats(reset=True)["events"] == {"split": 1, "join:device": 1}
