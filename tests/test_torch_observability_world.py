"""The observability and analysis planes of horovod_tpu_torch in worlds
of processes (gloo), every rank on the KV store ``run_world`` serves:

- the hang drill: the highest rank holds before its second collective of
  step 3, the watchdog fires, rank 0's diagnosis names it missing at the
  parked ``(step, gen, seq)``, ``HOROVOD_HANG_EVICT=1`` evicts it and the
  run finishes a rank smaller; the offline analysis of the sidecars alone
  names the same rank; every checked step's schedule hashes agree;
- the corrupt-rank drill: rank 2's fingerprint is made non-finite, the
  cross-check names it, ``publish_gate_reason`` reports the quarantine,
  and it is evicted;
- the aggregate plane (each rank's snapshot, rank 0's fleet view) and the
  timeline sidecars ``shutdown`` flushes, merged across ranks;
- the schedule recorder: one ZeRO-1 and one allreduce-mode step map onto
  ``tests/data/schedule_fingerprints.json`` by primitive and dtype;
- a rebuilt step's gradient hooks are removed: the model holds one hook a
  parameter after a 2 -> 1 -> 2 resize.

The JAX references are the pinned fingerprints and the flax parameters
the Tiny starts from.
"""

import json
import os
import pathlib

import pytest

from horovod_tpu_torch.observability import clock, flight
from horovod_tpu_torch.testing import run_world

import torch_observability_workers as OW
from test_torch_elastic import _flax_params

pytestmark = pytest.mark.torch_port

FINGERPRINTS = (pathlib.Path(__file__).parent / "data"
                / "schedule_fingerprints.json")


@pytest.fixture
def planes(tmp_path, monkeypatch):
    d = tmp_path / "obs"
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(d / "flight"))
    monkeypatch.setenv("HOROVOD_SANITIZE", "1")
    monkeypatch.setenv("HOROVOD_NUMERICS_FINGERPRINT", "1")
    monkeypatch.setenv("HOROVOD_HANG_TIMEOUT", "2")
    monkeypatch.setenv("HOROVOD_HANG_EVICT", "1")
    monkeypatch.setenv("HOROVOD_ELASTIC_HEARTBEAT_TTL", "10")
    return d


def test_hang_drill_names_and_evicts_the_hung_rank(planes):
    res = run_world(OW.drill_entry, 3, "hang", _flax_params(), 6.0,
                    timeout=180)
    r0 = res[0]
    assert r0["fired"] >= 1
    v = r0["verdict"]
    assert v["verdict"] == "rank_missing" and v["hung_ranks"] == [2]
    assert v["key"][0] == 3 and v["key"][2] == 1      # step 3, seq 1
    assert [r["final"] for r in res] == [True, True, False]
    assert [r["size"] for r in res[:2]] == [2, 2]
    assert r0["divergence"] is None and r0["checked"] >= 1
    assert 3 in r0["seen"] and r0["seen"][-1] == 2
    offline = flight.analyze_dir(str(planes / "flight"))
    assert offline["verdict"] == "rank_missing"
    assert offline["hung_ranks"] == [2]


def test_corrupt_drill_quarantines_and_evicts_rank_2(planes):
    res = run_world(OW.drill_entry, 3, "corrupt", _flax_params(),
                    timeout=180)
    r0 = res[0]
    assert r0["corrupt"] == {"rank": 2, "step": 2}
    assert r0["gates"] and r0["gates"][0] == "quarantine"
    assert [r["final"] for r in res] == [True, True, False]
    assert r0["divergence"] is None
    assert r0["seen"][-1] == 2
    assert r0["verdict"]["verdict"] is None       # no hang


def test_fleet_view_and_flushed_timeline_sidecars(tmp_path, monkeypatch):
    base = str(tmp_path / "timeline.json")
    monkeypatch.setenv("HOROVOD_TIMELINE", base)
    res = run_world(OW.fleet_timeline_worker, 2, _flax_params())
    assert res[0]["ranks"] == [0, 1] and res[0]["dead"] == []
    assert [r["train_steps"] for r in res] == [4.0, 4.0]
    assert res[0]["fleet_steps"] == [{"0": 4.0, "1": 4.0}]
    side = base + ".rank1.json"
    assert os.path.exists(base) and os.path.exists(side)
    merged = clock.merge_rank_traces([base, side])
    steps = [e for e in merged if e.get("tid") == "step"
             and e.get("ph") == "X"]
    assert sorted(e["pid"] for e in steps) == \
        ["rank0-host"] * 4 + ["rank1-host"] * 4
    json.dumps(merged)


#: the JAX matrix's cells the recorder is held against, with the count of
#: collectives each package issues where they differ: allreduce mode's
#: grouped exchange is one flat all_reduce of both f32 leaves where XLA
#: issues one psum a leaf
CELLS = {("zero1", "none"): None, ("zero1", "fp16"): None,
         ("zero1", "int8"): None, ("allreduce", "none"): (2, 3),
         ("allreduce", "fp16"): (2, 3)}


def _prims(ops, merge_leaves=False):
    seq = [(o[0], o[3]) for o in ops]
    if merge_leaves:        # consecutive same-dtype psums: one exchange
        out = []
        for p in seq:
            if not out or out[-1] != p or p[0] != "psum":
                out.append(p)
        return out
    return seq


def test_recorded_schedule_maps_onto_the_pinned_fingerprints():
    pins = json.loads(FINGERPRINTS.read_text())
    res = run_world(OW.schedule_worker, 2, list(CELLS))
    assert res[0] == res[1]
    for (sync, comp), counts in CELLS.items():
        got = res[0][f"{sync}|{comp}"]["ops"]
        want = pins[f"{sync}|{comp}|flat"]["ops"]
        assert all(o[1] == ["data"] for o in got)
        if counts is None:
            assert _prims(got) == _prims(want), (sync, comp, got, want)
            # ZeRO-1 at 2 ranks against XLA's at 8: the reduce-scatter
            # takes the same flat buffer, the all-gather each rank's shard
            for g, w in zip(got, want):
                if g[0] == "reduce_scatter":
                    assert g[2] == w[2]
                if g[0] == "all_gather":
                    assert g[2][0] * 2 == w[2][0] * 8
        else:
            # the grouped exchange: (port, JAX) collectives, the same
            # primitives and dtypes once XLA's per-leaf psums are merged
            assert (len(got), len(want)) == counts, (got, want)
            assert _prims(got) == _prims(want[:-1], merge_leaves=True) \
                + _prims(want[-1:])


def test_rebuilt_steps_leave_one_hook_a_parameter():
    res = run_world(OW.hooks_resize_worker, 2, _flax_params())
    r0 = res[0]
    worlds = [w for what, w, _ in r0["counts"] if what == "after"]
    assert worlds == [2, 1, 2]
    for what, _, n in r0["counts"]:
        assert n == (0 if what == "before" else r0["params"])
