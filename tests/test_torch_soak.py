"""The port's daemon soak (``tools/soak_server``) on the CPU at a tiny
size: a 3 s mixed soak of 2 slice clients and 1 volume client (HR 32^2,
the unet at base filters 16, its narrowest width) whose books balance,
each client's first response against ``upscale_batch`` on the same
slices, and ``check_books`` on books that do not balance."""

import copy

import numpy as np
import pytest
import torch

from mri_superresolution_torch.tools import soak_server

torch.set_num_threads(2)

ARGV = ["--cpu", "--seconds", "3", "--hw", "16", "--base_filters", "16",
        "--vol_slices", "4", "--slice_clients", "2", "--volume_clients", "1"]


@pytest.fixture(scope="module")
def soaked():
    args = soak_server.parse_args(ARGV)
    engine = soak_server.build_engine(args, torch.device("cpu"))
    return args, engine, soak_server.run_soak(engine, args)


def test_soak_books_balance(soaked, capsys):
    """Both kinds of client were served, the five checks hold, and
    ``main`` ends on SOAK OK."""
    args, _, books = soaked
    soak_server.check_books(books, args.max_pending)
    s = soak_server.summary(books)
    assert books["slices"] > 0 and books["volumes"] > 0
    assert s["requests"] == s["served_slices"] + 2 + args.vol_slices
    assert s["latency_ms"]["slice"]["requests"] > 0
    assert s["latency_ms"]["volume"]["p99"] >= \
        s["latency_ms"]["volume"]["p50"] > 0
    assert sum(s["batch_size_hist"].values()) == s["batches"]
    books = soak_server.main(ARGV[:2] + ["1"] + ARGV[3:])
    assert capsys.readouterr().out.rstrip().endswith("SOAK OK")
    assert not books["errors"] and not books["bad"]


def test_first_responses_are_upscale_batchs(soaked):
    """Each client's first response is, bit for bit, what
    ``upscale_batch`` gives for its request: a slice stack as posted, a
    volume's voxels in the transposed layout the raw path serves."""
    args, engine, books = soaked
    kinds = [f["kind"] for f in books["first"]]
    assert sorted(kinds) == ["slice"] * args.slice_clients + \
        ["volume"] * args.volume_clients
    for f in books["first"]:
        np.testing.assert_array_equal(
            f["output"], soak_server.direct_output(engine, f))


def _broken(books, what):
    b = copy.deepcopy({k: v for k, v in books.items() if k != "first"})
    stats = b["metrics"]["stats"]
    if what == "requests+1":
        stats["requests"] += 1
    elif what == "requests-1":
        stats["requests"] -= 1
    elif what == "queue_depth":
        b["metrics"]["queue_depth"] = 1
    elif what == "daemon_errors":
        stats["errors"] = 1
    elif what == "peak_pending":
        stats["peak_pending"] = 10 ** 6
    elif what == "client_error":
        b["errors"].append("slice[0]: HTTPError 503")
    elif what == "bad_response":
        b["bad"].append("volume[0]: (32, 32, 3) int16")
    return b


@pytest.mark.parametrize("what,match", [
    ("requests+1", "slice requests"), ("requests-1", "slice requests"),
    ("queue_depth", "queue depth 1"), ("daemon_errors", "1 errors"),
    ("peak_pending", "peak_pending"), ("client_error", "client errors"),
    ("bad_response", "wrong shape")])
def test_check_books_raises_on_books_that_do_not_balance(soaked, what,
                                                         match):
    args, _, books = soaked
    with pytest.raises(RuntimeError, match=match):
        soak_server.check_books(_broken(books, what), args.max_pending)


def test_soak_wants_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        soak_server.main(["--seconds", "1"])
