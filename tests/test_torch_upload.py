"""The port's chunked host-to-device upload (ballista_tpu_torch/ops/runtime.py
upload) against the JAX package's upload_array, on CPU tensors.

Both modules' _H2D_MIN_CHUNKED (256 MiB) and _H2D_CHUNK_BYTES (64 MiB) are
monkeypatched to a few KiB so that the chunked path runs at test size; no
source file changes for that. With the cost model on:
- the chunked upload is bit-identical to one put, for every dtype and
  rank the stages upload;
- it records one "h2d" observation per chunk, with the chunk's bytes, and
  so does the JAX package's upload_array on the same array and chunk size;
- a readback records one "readback" observation of its bytes.
With the cost model off it makes exactly one put.
"""

import numpy as np
import pytest
import torch

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.ops import costmodel as jcm
from ballista_tpu.ops import runtime as jrt
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.ops import costmodel as tcm
from ballista_tpu_torch.ops import runtime as trt

CPU = torch.device("cpu")
MIN_CHUNKED = 4 << 10
CHUNK = 1 << 10


def _model(on: bool):
    return {"ballista.tpu.cost_model": "true" if on else "false",
            "ballista.tpu.cost_model_dir": ""}


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    for mod in (trt, jrt):
        monkeypatch.setattr(mod, "_H2D_MIN_CHUNKED", MIN_CHUNKED)
        monkeypatch.setattr(mod, "_H2D_CHUNK_BYTES", CHUNK)
    for cm in (tcm, jcm):
        cm.reset(clear_dir=True)
    tcm.configure(BallistaConfig(_model(True)))
    jcm.configure(JaxConfig(_model(True)))
    yield
    for cm in (tcm, jcm):
        cm.reset(clear_dir=True)


def _arrays():
    rng = np.random.default_rng(20261017)
    return {
        "int32": rng.integers(-1 << 30, 1 << 30, 5000, dtype=np.int32),
        "float32_2d": rng.standard_normal((1700, 3)).astype(np.float32),
        "bool": rng.random(9000) < 0.5,
        "uint8_ragged": rng.integers(0, 255, 4099, dtype=np.uint8),
        "int16_view": rng.integers(-300, 300, 12000, dtype=np.int16)[::2],
    }


def _h2d(cm):
    """(observations, bytes) of the store's h2d entries."""
    snap = {k: v for k, v in cm.snapshot().items() if k.startswith("h2d|")}
    return sum(int(v["n"]) for v in snap.values()), sum(v["units"] for v in snap.values())


def _chunks(arr) -> int:
    rows = arr.shape[0]
    chunk_rows = max(1, CHUNK // max(1, arr.nbytes // rows))
    return -(-rows // chunk_rows)


@pytest.mark.parametrize("name", list(_arrays()))
def test_chunked_upload_is_bit_identical_to_one_put(name):
    arr = _arrays()[name]
    assert arr.nbytes >= MIN_CHUNKED and _chunks(arr) > 1
    got = trt.upload(arr, CPU)
    want = torch.from_numpy(np.ascontiguousarray(arr))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert trt.routing_stats()["h2d_chunk_bytes"] == CHUNK


@pytest.mark.parametrize("name", list(_arrays()))
def test_one_h2d_observation_per_chunk_as_reference(name):
    arr = _arrays()[name]
    trt.upload(arr, CPU)
    got = np.asarray(jrt.upload_array(np.ascontiguousarray(arr)))
    assert got.tobytes() == np.ascontiguousarray(arr).tobytes()
    port_n, port_bytes = _h2d(tcm)
    ref_n, ref_bytes = _h2d(jcm)
    assert port_n == ref_n == _chunks(arr)
    assert port_bytes == ref_bytes == arr.nbytes


def test_model_off_makes_one_put(monkeypatch):
    puts = []
    real = trt._put

    def counting(a, device):
        puts.append(a.nbytes)
        return real(a, device)

    monkeypatch.setattr(trt, "_put", counting)
    arr = _arrays()["int32"]
    tcm.configure(BallistaConfig(_model(False)))
    assert torch.equal(trt.upload(arr, CPU), torch.from_numpy(arr))
    assert puts == [arr.nbytes] and _h2d(tcm) == (0, 0)
    # the same array with the model on goes in chunks
    tcm.configure(BallistaConfig(_model(True)))
    puts.clear()
    assert torch.equal(trt.upload(arr, CPU), torch.from_numpy(arr))
    assert len(puts) == _chunks(arr) and sum(puts) == arr.nbytes


def test_small_array_is_one_put_without_observation():
    arr = np.arange(100, dtype=np.int32)
    assert torch.equal(trt.upload(arr, CPU), torch.from_numpy(arr))
    assert _h2d(tcm) == (0, 0)


def test_readback_observes_its_bytes():
    x = torch.arange(300, dtype=torch.float32)
    trt.readback_stats(reset=True)
    out = trt.readback(x)
    assert out.tobytes() == x.numpy().tobytes()
    rb = {k: v for k, v in tcm.snapshot().items() if k.startswith("readback|")}
    assert sum(v["n"] for v in rb.values()) == 1
    assert sum(v["units"] for v in rb.values()) == x.numel() * 4
    assert trt.readback_stats(reset=True)["bytes"] == x.numel() * 4
