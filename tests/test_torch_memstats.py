"""The port's memory accountant (util/memstats.py): the allocation
ledger on CPU tensors (register, release when a tensor is collected,
watermarks), out-of-memory classification and forensics, and the
report's keys against the JAX package's."""

import gc

import numpy as np
import pytest
import torch

from scanner_tpu.util import memstats as jms

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.common import DeviceOutOfMemory
from scanner_tpu_torch.engine import batch as tbatch
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.util import faults
from scanner_tpu_torch.util import memstats as tms
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import (  # noqa: F401
    ledger_leak_guard, stop_process_engine)


def test_register_release_watermark():
    dev, kind = "ledger-test:0", "staging"
    a = tms.register(1000, dev, kind)
    b = tms.register(500, dev, kind)
    assert tms.live_bytes(dev, kind) == 1500
    tms.release(a)
    tms.release(a)   # idempotent
    assert tms.live_bytes(dev, kind) == 500
    assert tms.watermark_bytes(dev, kind) == 1500
    tms.release(b)
    assert tms.live_bytes(dev, kind) == 0
    (row,) = [r for r in tms.ledger_summary() if r["device"] == dev]
    assert row == {"device": dev, "kind": kind, "live_bytes": 0,
                   "peak_bytes": 1500, "entries": 0}


def test_track_array_releases_when_the_tensor_is_collected():
    t = torch.zeros((4, 1000), dtype=torch.int32)
    eid = tms.track_array(t, "sink", device="track-test:0")
    assert eid is not None
    assert tms.live_bytes("track-test:0") == 16000
    top = [e for e in tms.top_entries(1000) if e["id"] == eid]
    assert top and top[0]["kind"] == "sink" and top[0]["bytes"] == 16000
    del t
    gc.collect()
    assert tms.live_bytes("track-test:0") == 0
    assert tms.watermark_bytes("track-test:0") == 16000
    assert tms.track_array(np.zeros(4), "sink") is None   # not a tensor
    assert tms.track_array(torch.zeros(0), "sink") is None


def test_disabled_ledger_registers_nothing():
    tms.set_enabled(False)
    try:
        assert tms.register(10, "off:0", "staging") is None
        assert tms.track_array(torch.zeros(4), "staging") is None
    finally:
        tms.set_enabled(True)


def test_is_oom():
    assert tms.is_oom(DeviceOutOfMemory("staging"))
    assert tms.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not tms.is_oom(RuntimeError("CUDA error: invalid argument"))


def test_report_and_status_keys_match_jax():
    assert set(tms.memory_report()) == set(jms.memory_report())
    assert set(tms.status_dict()) == set(jms.status_dict())
    # no card in this process: device stats are absent, as on JAX's CPU
    assert tms.device_memory_stats() == {}
    assert tms.device_label(None) == "default"
    assert tms.device_label(torch.device("cuda", 1)) == "cuda:1"


def test_staging_oom_is_noted_with_its_site():
    before = tms.status_dict()["oom_events"]
    faults.install("memory.pressure:raise:exc=oom")
    try:
        with pytest.raises(DeviceOutOfMemory):
            tbatch.staged_device_put(np.zeros((2, 4), np.uint8),
                                     torch.device("cpu"), "staging",
                                     fault_detail="test")
    finally:
        faults.clear()
    st_ = tms.status_dict()
    assert st_["oom_events"] == before + 1
    assert st_["last_oom"]["site"] == "staging"
    report = tms.last_report()
    assert report["site"] == "staging" and "h2d 8 bytes" in report["detail"]


def test_a_staged_run_tracks_staging_buffers(tmp_path):
    """The card's path on CPU tensors registers each staged column; once
    the run's tensors are collected none of them stays live."""
    f = np.random.RandomState(2).randint(0, 256, (12, 16, 16, 3)) \
        .astype(np.uint8)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[x] for x in f],
                     codecs={"frame": "pickle"})
        gc.collect()
        live0 = tms.live_bytes("cpu", "staging")
        peak0 = tms.watermark_bytes("cpu", "staging")
        ex = LocalExecutor(sc._db, Profiler(), torch.device("cpu"),
                           stage=True)
        ex.run([sc.io.Output(sc.ops.Histogram(
                    frame=sc.io.Input([st.NamedStream(sc, "frames")])),
                    [st.NamedStream(sc, "hist")])],
               st.PerfParams.manual(4, 8))
    finally:
        sc.stop()
    gc.collect()
    assert tms.watermark_bytes("cpu", "staging") >= max(peak0, 8 * 16 * 16 * 3)
    assert tms.live_bytes("cpu", "staging") <= live0
    report = sc.memory_report()
    assert set(report) == {"memory", "reports"}
    assert any(r["kind"] == "staging" for r in report["memory"]["ledger"])


def test_entries_match_jax():
    """entries() lists each live registration with the JAX package's
    keys and values, and drops it once released."""
    dev, kind = "entries-test:0", "staging"
    ids = {pkg: pkg.register(4096, dev, kind) for pkg in (jms, tms)}
    try:
        rows = {pkg: [e for e in pkg.entries() if e["id"] == ids[pkg]]
                for pkg in (jms, tms)}
        (want,), (got,) = rows[jms], rows[tms]
        assert set(got) == set(want)
        for key in ("bytes", "device", "kind"):
            assert got[key] == want[key]
    finally:
        for pkg, eid in ids.items():
            pkg.release(eid)
    for pkg, eid in ids.items():
        assert all(e["id"] != eid for e in pkg.entries())


def test_staged_run_leaves_no_entry(tmp_path, ledger_leak_guard):
    """A staged Histogram run on CPU tensors: every ledger entry the run
    registered is released once its tensors are collected."""
    f = np.random.RandomState(3).randint(0, 256, (12, 16, 16, 3)) \
        .astype(np.uint8)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[x] for x in f],
                     codecs={"frame": "pickle"})
        ex = LocalExecutor(sc._db, Profiler(), torch.device("cpu"),
                           stage=True)
        ex.run([sc.io.Output(sc.ops.Histogram(
                    frame=sc.io.Input([st.NamedStream(sc, "frames")])),
                    [st.NamedStream(sc, "hist")])],
               st.PerfParams.manual(4, 8))
        assert ledger_leak_guard.watermark_bytes("cpu", "staging") > 0
    finally:
        sc.stop()
