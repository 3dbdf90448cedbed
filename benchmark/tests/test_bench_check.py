"""The check that decides ``correct``, driven through whole runs on the
CPU at a small size: the program passes it; the fp8 control and each
fault planted under the timed path fail it."""

import pytest

from benchmark import core, faults, traffic
from benchmark.tests.small import MAN, SMALL, run

KINDS = {w["name"]: traffic.load(w["traffic"])["kind"]
         for w in MAN["workloads"]}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_program_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_refused(workload):
    r = run(workload, system="control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in sorted(SMALL) for f in faults.FAULTS[KINDS[w]]])
def test_fault_is_refused(workload, fault):
    with faults.planted(fault, KINDS[workload]):
        r = run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_run_reads_its_metrics(workload):
    r = run(workload, trace=True)
    assert r["correct"]
    # on the CPU no device metric has anything to read; the host clock's
    # metrics read the untraced part of the window
    for name in r["metrics"]:
        assert not name.startswith(("idle_share", "copy_ms", "b1_"))
    host = {m["name"] for m in core.cell_metrics(MAN, workload, True)
            if m["source"] == "host_clock"}
    assert host and host <= set(r["metrics"])
