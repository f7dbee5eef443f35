"""The port's keyed kernel build cache (ballista_tpu_torch/ops/cuda_kernels.py),
the counterpart of the JAX package's program cache (ops/aotcache.py): each
library's file name carries a sha256 of its source, every header,
NVCC_FLAGS, `nvcc --version` and the card's compute capability, so any
change of those builds anew and a library whose key is on disk loads with
no nvcc. Events count in runtime.serving_stats() under the reference's
names ("compile_hit_memory", "compile_hit_disk", "compile_prewarmed") and
"kernel_built" for one nvcc run.

The CPU tests inject the toolchain (nvcc version, capability) and replace
the nvcc launch with a stand-in that writes each output, over a copy of
the sources in a temporary directory: no nvcc, no card. The tests marked
`cuda` build and load the real libraries on the card.
"""

import json
import pathlib
import shutil
import types

import pyarrow as pa
import pytest

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.ops import cuda_kernels as ck
from ballista_tpu_torch.ops import runtime

NAMES = ["grouped_aggregate", "sorted_grouped_sum"]


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """Sources copied to tmp, the build directory in tmp, an injected
    toolchain, and an nvcc stand-in. Returns a dict the test may change:
    "version", "capability", "fail" (make every compile fail) and "jobs"
    (the sources each compile call got)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(ck.CSRC, csrc)
    state = {"version": "Cuda compilation tools, release 12.4, V12.4.131",
             "capability": "9.0", "fail": False, "jobs": []}

    def toolchain():
        return "nvcc-stand-in", state["version"], state["capability"]

    def compile_(jobs):
        state["jobs"].append(sorted(src.stem for src, _out, _nvcc in jobs))
        if state["fail"]:
            return [(2, f"{src.name}: error: stand-in failure") for src, _o, _n in jobs]
        for _src, out, _nvcc in jobs:
            out.write_bytes(b"\x7fELF stand-in")
        return [(0, "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
                    "ptxas info    : Used 32 registers, 16 bytes smem") for _ in jobs]

    monkeypatch.setattr(ck, "CSRC", csrc)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build" / "kernels")
    monkeypatch.setattr(ck, "_toolchain", toolchain)
    monkeypatch.setattr(ck, "_compile", compile_)
    monkeypatch.setattr(ck, "_libs", {})
    runtime.serving_stats(reset=True)
    yield state
    runtime.serving_stats(reset=True)


def _key(src, **over):
    args = {"flags": list(ck.NVCC_FLAGS),
            "nvcc_version": "Cuda compilation tools, release 12.4, V12.4.131",
            "capability": "9.0", **over}
    return ck.build_key(src, args["flags"], args["nvcc_version"], args["capability"])


@pytest.mark.parametrize("change", ["flags", "nvcc_version", "capability"])
def test_key_changes_with_each_input(change):
    src = ck.CSRC / "sorted_grouped_sum.cu"
    base = _key(src)
    assert base == _key(src)  # deterministic
    other = {"flags": ck.NVCC_FLAGS + ["-lineinfo"],
             "nvcc_version": "Cuda compilation tools, release 12.6, V12.6.20",
             "capability": "8.0"}[change]
    assert _key(src, **{change: other}) != base


def test_key_changes_with_source_and_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(ck.CSRC, csrc)
    src = csrc / "sorted_grouped_sum.cu"
    base = _key(src)
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// a changed header\n")
    after_header = _key(src)
    assert after_header != base
    src.write_text(src.read_text() + "\n// a changed source\n")
    assert _key(src) != after_header
    # another kernel's source is not an input of this one
    other = csrc / "grouped_aggregate.cu"
    other_before = _key(src)
    other.write_text(other.read_text() + "\n")
    assert _key(src) == other_before


def test_second_build_runs_no_nvcc(fake_build):
    first = ck.build()
    assert sorted(first) == NAMES
    assert fake_build["jobs"] == [NAMES]
    assert runtime.serving_stats(reset=True) == {"kernel_built": 2}
    for name, b in first.items():
        assert b["seconds"] is not None
        assert pathlib.Path(b["library"]).name == f"lib{name}-{b['key'][:16]}.so"
        assert [(f["registers"], f["smem_bytes"]) for f in b["ptxas"]] == [(32, 16)]
    second = ck.build()
    assert fake_build["jobs"] == [NAMES]  # no second compile
    assert runtime.serving_stats(reset=True) == {"compile_hit_disk": 2}
    assert all(b["seconds"] is None for b in second.values())
    assert {n: b["key"] for n, b in second.items()} == {n: b["key"] for n, b in first.items()}
    entries = ck.manifest()
    assert sorted(entries) == sorted(b["key"] for b in first.values())
    for key, e in entries.items():
        assert e["library"] == f"lib{e['name']}-{key[:16]}.so"
        assert e["flags"] == ck.NVCC_FLAGS
        assert e["nvcc"] == "Cuda compilation tools, release 12.4, V12.4.131"
        assert e["capability"] == "9.0"
    on_disk = json.loads((ck.BUILD_DIR / "manifest.json").read_text())
    assert on_disk == entries


@pytest.mark.parametrize("change", ["flags", "header", "nvcc_version", "capability"])
def test_changed_input_rebuilds(fake_build, monkeypatch, change):
    first = ck.build()
    if change == "flags":
        monkeypatch.setattr(ck, "NVCC_FLAGS", ck.NVCC_FLAGS + ["-lineinfo"])
    elif change == "header":
        header = next(ck.CSRC.glob("*.cuh"))
        header.write_text(header.read_text() + "\n// changed\n")
    elif change == "nvcc_version":
        fake_build["version"] = "Cuda compilation tools, release 12.6, V12.6.20"
    else:
        fake_build["capability"] = "10.0"
    runtime.serving_stats(reset=True)
    second = ck.build()
    assert fake_build["jobs"] == [NAMES, NAMES]
    assert runtime.serving_stats(reset=True) == {"kernel_built": 2}
    for name in NAMES:
        assert second[name]["key"] != first[name]["key"]
        assert second[name]["library"] != first[name]["library"]
        # the earlier library stays; nothing overwrote it
        assert pathlib.Path(first[name]["library"]).exists()
    assert len(ck.manifest()) == 4


class _LoadedStandIn:
    """What ctypes.CDLL returns for a stand-in library: the one entry
    _load_locked calls."""

    def bt_sorted_grouped_sum_tile_rows(self):
        return ck.SORTED_TILE_ROWS


def test_prewarm_builds_missing_libraries_together_and_counts_once(fake_build, monkeypatch):
    """prewarm on a card (the loads stood in): over an empty build directory
    every library compiles in ONE nvcc batch, and over a warm one a new
    process counts one compile_hit_disk and one compile_prewarmed per
    library, as chip_smoke.py's phase 9 requires; loaded_libraries()
    reports the compile seconds, or None for a library found on disk."""
    monkeypatch.setattr(ck, "ctypes", types.SimpleNamespace(CDLL=lambda path: _LoadedStandIn()))
    monkeypatch.setattr(ck, "_bind", lambda name, lib: None)
    monkeypatch.setattr(ck, "_compiled_s", {})
    config = BallistaConfig({"ballista.tpu.prewarm": "true"})
    assert ck.prewarm(config, device="cuda") == 2
    assert fake_build["jobs"] == [NAMES]
    assert runtime.serving_stats(reset=True) == {"kernel_built": 2, "compile_prewarmed": 2}
    assert sorted(ck.loaded_libraries()) == NAMES
    assert all(s is not None for s in ck.loaded_libraries().values())
    # a second prewarm finds both loaded
    assert ck.prewarm(config, device="cuda") == 0
    assert runtime.serving_stats(reset=True) == {"compile_hit_memory": 2}
    # a new process over the warm directory
    monkeypatch.setattr(ck, "_libs", {})
    monkeypatch.setattr(ck, "_compiled_s", {})
    assert ck.prewarm(config, device="cuda") == 2
    assert fake_build["jobs"] == [NAMES]
    assert runtime.serving_stats(reset=True) == {"compile_hit_disk": 2, "compile_prewarmed": 2}
    assert ck.loaded_libraries() == {name: None for name in NAMES}


def test_failed_build_raises_and_prewarm_raises(fake_build):
    fake_build["fail"] = True
    with pytest.raises(RuntimeError, match="stand-in failure"):
        ck.build()
    # on a card a kernel that does not build is never skipped
    with pytest.raises(RuntimeError, match="stand-in failure"):
        ck.prewarm(BallistaConfig({"ballista.tpu.prewarm": "true"}), device="cuda")
    assert "kernel_built" not in runtime.serving_stats()


def test_prewarm_on_cpu_touches_no_nvcc(monkeypatch):
    """On CPU tensors prewarm returns 0 and never asks for nvcc; an
    ExecutionContext with ballista.tpu.prewarm set starts as before."""
    def boom(*a, **k):
        raise AssertionError("nvcc touched on a CPU device")

    monkeypatch.setattr(ck, "_toolchain", boom)
    monkeypatch.setattr(ck, "_compile", boom)
    monkeypatch.setattr(ck, "_nvcc", boom)
    runtime.serving_stats(reset=True)
    config = BallistaConfig({"ballista.tpu.prewarm": "true"})
    assert ck.prewarm(config, device="cpu") == 0
    from ballista_tpu_torch.engine import ExecutionContext

    ctx = ExecutionContext(config, device="cpu")
    ctx.register_record_batches("t", pa.table({"x": [1, 2, 3]}))
    assert ctx.sql("select sum(x) as s from t").collect().column("s").to_pylist() == [6]
    assert runtime.serving_stats(reset=True) == {}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_second_build_runs_no_nvcc_and_prewarm_loads(cuda_device):
    ck.build()
    runtime.serving_stats(reset=True)
    built = ck.build()
    assert all(b["seconds"] is None for b in built.values())
    assert runtime.serving_stats(reset=True) == {"compile_hit_disk": len(built)}
    loaded = ck.prewarm(BallistaConfig({"ballista.tpu.prewarm": "true"}), cuda_device)
    stats = runtime.serving_stats(reset=True)
    assert stats.get("kernel_built", 0) == 0
    assert stats.get("compile_prewarmed", 0) == loaded
