"""The durable control plane (engine/journal.py, engine/shardmap.py),
clock sync (util/clocksync.py) and the config file (config.py): the
JAX package and the port on the same seeded inputs.  Journal segments
and shard-map blobs must be the same bytes, and each package must read
the other's; generation claims must have exactly one winner; clock
offsets and parsed configs must be equal."""

import random
import threading

import pytest

from scanner_tpu import config as jconfig
from scanner_tpu.engine import journal as jjournal
from scanner_tpu.engine import shardmap as jshardmap
from scanner_tpu.storage import metadata as jmd
from scanner_tpu.storage.backend import MemoryStorage as JMemory
from scanner_tpu.storage.backend import PosixStorage as JPosix
from scanner_tpu.util import clocksync as jclock

from scanner_tpu_torch import config as tconfig
from scanner_tpu_torch.engine import journal as tjournal
from scanner_tpu_torch.engine import shardmap as tshardmap
from scanner_tpu_torch.storage import metadata as tmd
from scanner_tpu_torch.storage.backend import MemoryStorage as TMemory
from scanner_tpu_torch.storage.backend import PosixStorage as TPosix
from scanner_tpu_torch.util import clocksync as tclock

PKGS = {"jax": (jjournal, JPosix, JMemory, jmd),
        "torch": (tjournal, TPosix, TMemory, tmd)}


def _records(seed: int, n: int):
    """Seeded journal records of every type the master writes."""
    rng = random.Random(seed)
    kinds = ("admit", "done", "strike", "transient", "blacklist",
             "commit", "gang", "gang_abort")
    out = []
    for i in range(n):
        t = kinds[rng.randrange(len(kinds))]
        rec = {"t": t, "j": rng.randrange(4), "k": i}
        if t == "admit":
            rec.update(token=f"{rng.getrandbits(64):016x}",
                       bulk=rng.randrange(9))
        elif t in ("strike", "transient", "blacklist"):
            rec["err"] = "RuntimeError: " + "x" * rng.randrange(40)
        elif t in ("gang", "gang_abort"):
            rec.update(g=rng.randrange(5), e=rng.randrange(1, 7))
        out.append(rec)
    return out


def _write(pkg: str, backend, generation: int, recs, rotate: int):
    journal = PKGS[pkg][0]
    j = journal.BulkJournal(backend, generation=generation, rotate=rotate)
    for r in recs:
        j.append(r)
    return j


# -- journal ------------------------------------------------------------------

def test_record_framing_same_bytes():
    for rec in _records(3, 40):
        enc = tjournal.encode_record(rec)
        assert enc == jjournal.encode_record(rec)
        assert jjournal.decode_segment(enc) == ([rec], None)
        assert tjournal.decode_segment(jjournal.encode_record(rec)) == \
            ([rec], None)
    # a truncated frame reads as a torn tail in both packages
    seg = b"".join(tjournal.encode_record(r) for r in _records(4, 5))
    assert tjournal.decode_segment(seg[:-3]) == \
        jjournal.decode_segment(seg[:-3])
    assert tjournal.decode_segment(seg[:-3])[1] == "torn"


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_segments_same_bytes_and_cross_replay(tmp_path, writer, reader):
    """A journal of 37 records at rotate=8 (five segments) written by
    one package: the same object names and bytes as the other writes,
    and the other package replays it to the same records."""
    recs = _records(11, 37)
    roots = {p: str(tmp_path / p) for p in PKGS}
    for p in PKGS:
        _write(p, PKGS[p][1](roots[p]), 4, recs, rotate=8)
    wb = PKGS[writer][1](roots[writer])
    ob = PKGS[reader][1](roots[reader])
    prefix = tmd.journal_dir(4)
    assert prefix == jmd.journal_dir(4)
    segs = wb.list_prefix(prefix)
    assert len(segs) == 5
    assert segs == ob.list_prefix(prefix)
    for path in segs:
        assert wb.read(path) == ob.read(path), path
    got, stats = PKGS[reader][0].replay(PKGS[reader][1](roots[writer]), 4)
    assert got == recs
    assert stats["records"] == 37 and stats["corrupt"] == 0


def test_rotation_cut_compaction_equal():
    out = {}
    for p in PKGS:
        journal, _posix, memory, md = PKGS[p]
        s = memory()
        j = _write(p, s, 3, [{"t": "done", "j": 0, "k": i}
                             for i in range(10)], rotate=4)
        segs = s.list_prefix(md.journal_dir(3))
        cut = j.cut()
        j.append({"t": "done", "j": 0, "k": 99})
        j.compact_below(cut)
        recs, _stats = journal.replay(s, 3)
        j.reset()
        out[p] = (segs, cut, [r["k"] for r in recs],
                  s.list_prefix(md.journal_dir(3)))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == [99] and out["torch"][3] == []


@pytest.mark.parametrize("cut_bytes", [1, 7, 13])
def test_torn_tail_tolerated_equal(cut_bytes):
    """A crash mid-append truncates the final record: both packages
    replay the records before it and count one torn tail."""
    out = {}
    for p in PKGS:
        journal, _posix, memory, md = PKGS[p]
        s = memory()
        _write(p, s, 1, [{"t": "done", "j": 0, "k": i} for i in range(5)],
               rotate=100)
        path = md.journal_segment_path(1, 0)
        s.write(path, s.read(path)[:-cut_bytes])
        recs, stats = journal.replay(s, 1)
        out[p] = ([r["k"] for r in recs], stats["torn"], stats["corrupt"])
    assert out["torch"] == out["jax"] == ([0, 1, 2, 3], 1, 0)


def test_corrupt_mid_stream_stops_at_error_equal():
    """Rot inside the first record's payload (not a torn tail): replay
    stops at the corruption, in both packages, on either's segment."""
    out = {}
    for p in PKGS:
        journal, _posix, memory, md = PKGS[p]
        s = memory()
        _write(p, s, 1, [{"t": "done", "j": 0, "k": i} for i in range(6)],
               rotate=3)
        path = md.journal_segment_path(1, 0)
        blob = bytearray(s.read(path))
        blob[14] ^= 0xFF
        s.write(path, bytes(blob))
        recs, stats = journal.replay(s, 1)
        out[p] = ([r["k"] for r in recs], stats["corrupt"])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 1 and all(k < 3 for k in out["torch"][0])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_generation_claims_exactly_one_winner(pkg, tmp_path):
    """Eight racers for one generation on a shared directory: exactly
    one wins.  Claims made by one package count for the other."""
    journal, posix, _memory, _md = PKGS[pkg]
    other = PKGS["torch" if pkg == "jax" else "jax"]
    s = posix(str(tmp_path / "db"))
    wins = []
    barrier = threading.Barrier(8)

    def racer():
        barrier.wait()
        if journal.try_claim(s, 5, note="racer"):
            wins.append(1)

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1
    os_ = other[1](str(tmp_path / "db"))
    assert other[0].highest_claimed(os_) == 5
    assert journal.claim_generation(s) == 6
    assert other[0].claim_generation(os_) == 7
    assert journal.claimed_generations(s) == [5, 6, 7]


def test_generation_latch_equal():
    replies = [{"generation": 2}, {"generation": 2}, {"no_generation": 1},
               None, {"generation": 1}, {"generation": 4},
               {"generation": 3}]
    out = {}
    for p in PKGS:
        latch = PKGS[p][0].GenerationLatch()
        out[p] = ([latch.observe(r) for r in replies], latch.highest())
    assert out["torch"] == out["jax"]
    assert out["torch"] == ([True, True, True, True, False, True, False],
                            4)


# -- shard map ------------------------------------------------------------

def test_stable_hash_equal_on_1000_keys():
    rng = random.Random(2)
    keys = [f"{rng.getrandbits(128):032x}" for _ in range(997)] + \
        ["", "job-token-1", "s01/bulk/7"]
    assert [tshardmap.stable_hash(k) for k in keys] == \
        [jshardmap.stable_hash(k) for k in keys]


@pytest.mark.parametrize("shards", [{0: "a"}, {0: "h0:1", 1: "h1:2",
                                               2: "h2:3"},
                                    {0: "x:1", 2: "y:2", 5: "z:3"}])
def test_shard_maps_route_equal(shards):
    tm = tshardmap.ShardMap(epoch=4, shards=shards, num_shards=6)
    jm = jshardmap.ShardMap(epoch=4, shards=shards, num_shards=6)
    assert tm.to_dict() == jm.to_dict()
    keys = [f"token-{i}" for i in range(1000)]
    assert [tm.shard_for(k) for k in keys] == \
        [jm.shard_for(k) for k in keys]


def test_shard_map_blobs_same_bytes_and_cross_load(tmp_path):
    """Three registrations (one a re-publish at a new address) through
    each package: the same epochs, paths and bytes; each loads the
    other's map."""
    backs = {}
    for p, mod, posix in (("jax", jshardmap, JPosix),
                          ("torch", tshardmap, TPosix)):
        s = posix(str(tmp_path / p))
        for sid, addr in ((0, "h0:1"), (1, "h1:1"), (2, "h2:1"),
                          (1, "h1:9")):
            mod.register_shard(s, sid, addr, num_shards=3)
        backs[p] = s
    paths = backs["torch"].list_prefix(tmd.shardmap_prefix())
    assert paths == backs["jax"].list_prefix(jmd.shardmap_prefix())
    for path in paths:
        assert backs["torch"].read(path) == backs["jax"].read(path)
    for mod, other in ((tshardmap, "jax"), (jshardmap, "torch")):
        got = mod.load(backs[other])
        assert got.epoch == 4
        assert got.shards == {0: "h0:1", 1: "h1:9", 2: "h2:1"}
    assert tshardmap.ShardMap.from_dict(
        jshardmap.load(backs["jax"]).to_dict()).to_dict() == \
        tshardmap.load(backs["torch"]).to_dict()


def test_map_holder_equal():
    out = {}
    for p, mod in (("jax", jshardmap), ("torch", tshardmap)):
        h = mod.MapHolder()
        steps = [h.get() is None, h.epoch()]
        for e, a in ((3, "a"), (3, "b"), (2, "b"), (4, "b")):
            steps.append(h.observe(mod.ShardMap(epoch=e, shards={0: a})))
        steps += [h.observe(None), h.epoch(), h.get().shards]
        out[p] = steps
    assert out["torch"] == out["jax"]


# -- clock sync -----------------------------------------------------------

def _exchanges(seed: int, n: int, offset: float, step_at=None):
    """Seeded four-timestamp exchanges: jittered one-way delays, an
    optional step in the peer clock, and a non-causal sample."""
    rng = random.Random(seed)
    out, t0 = [], 1000.0
    for i in range(n):
        off = offset + (0.3 if step_at is not None and i >= step_at
                        else 0.0)
        up = 0.001 + rng.random() * 0.02
        down = 0.001 + rng.random() * 0.02
        t1 = t0 + off + up
        t2 = t1 + 0.0001
        t3 = t2 - off + down
        out.append((t0, t1, t2, t3))
        t0 = t3 + 1.0
    out.insert(n // 2, (t0, t0 + 0.5, t0 + 0.5001, t0 - 0.1))
    return out


@pytest.mark.parametrize("seed,offset,step_at", [(0, 0.5, None),
                                                 (7, -0.25, None),
                                                 (3, 0.05, 40)])
def test_clocksync_estimates_equal(seed, offset, step_at):
    samples = _exchanges(seed, 64, offset, step_at)
    ests = {}
    for p, mod in (("jax", jclock), ("torch", tclock)):
        est = mod.OffsetEstimator()
        trail = []
        for s in samples:
            est.add_sample(*s)
            trail.append(est.estimate())
        ests[p] = trail
    assert ests["torch"] == ests["jax"]
    last = ests["torch"][-1]
    want = offset + (0.3 if step_at is not None else 0.0)
    assert abs(last["offset"] - want) <= last["uncertainty"] + 1e-9


def test_rebase_and_should_rebase_equal():
    spans = [
        {"node": "workerA", "name": "task", "start": 10.0, "end": 11.0,
         "events": [{"name": "barrier.enter", "t": 10.5}, {"name": "x"}]},
        {"node": "workerB", "name": "task", "start": 20.0, "end": 21.0},
        {"node": "master", "name": "job", "start": 5.0, "end": 30.0},
    ]
    offsets = {"workerA": {"offset": 2.0, "uncertainty": 0.001},
               "workerB": {"offset": 9.0, "uncertainty": 5.0}}
    assert tclock.rebase_spans(spans, offsets) == \
        jclock.rebase_spans(spans, offsets)
    assert tclock.rebase_spans(spans, offsets, 10.0) == \
        jclock.rebase_spans(spans, offsets, 10.0)
    for est in (None, {}, {"offset": 0.1, "uncertainty": 1.0},
                {"offset": 0.1, "uncertainty": 0.01},
                {"offset": 0.1, "uncertainty": "nan?"}):
        for limit in (None, 0.001, 2.0):
            assert tclock.should_rebase(est, limit) == \
                jclock.should_rebase(est, limit)


# -- config ---------------------------------------------------------------

ALL_SECTIONS = """
[storage]
type = "gcs"
db_path = "gs://bucket/prefix"
[network]
master = "head-node"
master_port = 6123
worker_port = 6124
metrics_port = 9100
[perf]
compilation_cache_dir = "/var/cache/x"
frame_cache_enabled = false
frame_cache_mb = 512
frame_cache_page_frames = 48
fusion_enabled = false
fusion_min_chain = 3
[memory]
enabled = false
report_top_n = 4
[trace]
enabled = false
clocksync_enabled = false
rebase_clocks = false
[alerts]
enabled = false
rules = "name=q_deep;form=threshold;series=scanner_tpu_stage_queue_depth;op=>;value=3"
[remediation]
enabled = false
dry_run = true
autoscale_min = 2
autoscale_max = 5
[robustness]
journal_enabled = false
journal_rotate_records = 17
[gang]
enabled = false
init_timeout_s = 12
form_timeout_s = 2.5
sharded = false
halo_exchange = false
[control]
shards = 3
[faults]
plan = "storage.read:raise:n=3"
[extra]
unknown_key = 1
"""

PROPS = [n for n, v in vars(jconfig.Config).items()
         if isinstance(v, property)]


def test_default_config_dump_equal():
    assert tconfig.dump_toml(tconfig.default_config()) == \
        jconfig.dump_toml(jconfig.default_config())
    assert tconfig.default_config() == jconfig.default_config()


@pytest.mark.parametrize("text", ["default", "all"])
def test_config_parses_equal(tmp_path, text):
    path = tmp_path / "cfg.toml"
    path.write_text(jconfig.dump_toml(jconfig.default_config())
                    if text == "default" else ALL_SECTIONS)
    jc, tc = jconfig.Config(str(path)), tconfig.Config(str(path))
    assert tc.config == jc.config
    assert set(PROPS) == {
        n for n, v in vars(tconfig.Config).items()
        if isinstance(v, property)}
    for name in PROPS:
        assert getattr(tc, name) == getattr(jc, name), name
    if text == "all":
        assert tc.master_address == "head-node:6123"
        assert tc.remediation_autoscale_bounds == (2, 5)
        assert tc.frame_cache_mb == 512 and tc.control_shards == 3


def test_gang_keys_applied_by_both(tmp_path, monkeypatch):
    """The [gang] keys land in each package's engine/gang.py setters
    through its client's config path, with the same values."""
    from scanner_tpu.engine import client as jclient
    from scanner_tpu.engine import gang as jgang
    from scanner_tpu_torch.engine import client as tclient
    from scanner_tpu_torch.engine import gang as tgang
    for var in ("SCANNER_TPU_GANG", "SCANNER_TPU_GANG_INIT_TIMEOUT",
                "SCANNER_TPU_GANG_FORM_TIMEOUT", "SCANNER_TPU_GANG_SHARDED",
                "SCANNER_TPU_GANG_HALO", "SCANNER_TPU_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    path = tmp_path / "cfg.toml"
    path.write_text(ALL_SECTIONS[ALL_SECTIONS.index("[gang]"):
                                 ALL_SECTIONS.index("[control]")])
    getters = ("enabled", "init_timeout_s", "form_timeout_s",
               "sharded_enabled", "halo_enabled")
    saved = [(m, [getattr(m, g)() for g in getters])
             for m in (jgang, tgang)]
    try:
        tclient._apply_config(tconfig.Config(str(path)))
        jc = jclient.Client(db_path=str(tmp_path / "jdb"),
                            config_path=str(path))
        jc.stop()
        want = [False, 12.0, 2.5, False, False]
        assert [getattr(tgang, g)() for g in getters] == want
        assert [getattr(jgang, g)() for g in getters] == want
    finally:
        for m, vals in saved:
            m.set_enabled(vals[0])
            m.set_init_timeout_s(vals[1])
            m.set_form_timeout_s(vals[2])
            m.set_sharded(vals[3])
            m.set_halo(vals[4])


def test_config_missing_file_raises(tmp_path):
    from scanner_tpu_torch.common import ScannerException
    with pytest.raises(ScannerException):
        tconfig.Config(str(tmp_path / "nope.toml"))
