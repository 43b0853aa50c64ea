"""The port's program spans (utils/timing.py: span, enable_spans,
set_request, span_records) on the CPU: nothing while they are off, the
records while they are on, the profiler's clock, and the spans of the
NTT, the sumcheck prover and the sharded NTT in their nesting, with
outputs word-equal to a run with the spans off."""

import json
import types

import numpy as np
import pytest
import torch

from binius_ntt_tpu_torch import _build
from binius_ntt_tpu_torch.ntt.additive_bitsliced import AdditiveNTT128
from binius_ntt_tpu_torch.parallel.mesh import LocalMesh
from binius_ntt_tpu_torch.parallel.ntt128_sharded import (
    OVERLAP_HALVES, ShardedAdditiveNTT128)
from binius_ntt_tpu_torch.sumcheck.prover import Sumcheck
from binius_ntt_tpu_torch.utils import timing
from binius_ntt_tpu_torch.utils.timing import (enable_spans, set_request,
                                               span, span_records, trace_to)


@pytest.fixture
def spans_on():
    """Spans on for the test, with nothing recorded before it; off and
    cleared after it."""
    span_records()
    enable_spans(True)
    set_request(None)
    try:
        yield
    finally:
        enable_spans(False)
        set_request(None)
        span_records()


def _raise(*a, **k):
    raise AssertionError("called while spans are off")


def _words(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                         generator=g)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _ids(recs):
    return {r["id"]: r for r in recs}


def _parent_name(r, recs):
    p = _ids(recs).get(r["parent"])
    return None if p is None else p["name"]


# ---- the API ---------------------------------------------------------------

def test_off_returns_one_null_span_and_touches_no_event_or_range(
        monkeypatch):
    assert not timing.spans_enabled()
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    a, b = span("a"), span("b", torch.device("cpu"), k=3)
    assert a is b
    with a as s:
        s.add("x", 5)
    ntt = AdditiveNTT128(8, 2, device="cpu")
    ntt.apply(_words(4 << 8, 1))
    ntt.apply_sliced(_words(3 << 10, 2).view(3, 8, 128))
    assert span_records() == []


def test_on_records_parents_requests_and_counts(spans_on):
    set_request(7)
    with span("outer", torch.device("cpu"), k=2) as outer:
        outer.add("bytes", 10)
        with span("inner") as inner:
            inner.add("n")
            inner.add("n", 2)
        outer.add("bytes", 5)
    set_request("setup")
    with span("later"):
        pass
    recs = span_records()
    assert span_records() == []
    byname = _by_name(recs)
    outer, inner, later = (byname[n][0] for n in ("outer", "inner",
                                                   "later"))
    assert [r["name"] for r in recs] == ["inner", "outer", "later"]
    assert outer["parent"] is None and later["parent"] is None
    assert inner["parent"] == outer["id"]
    assert outer["request"] == inner["request"] == 7
    assert later["request"] == "setup"
    assert outer["counts"] == {"bytes": 15} and inner["counts"] == {"n": 3}
    assert outer["attrs"] == {"k": 2}
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= outer["t1_ns"]
    # a device span off the card keeps its host time as device time; a
    # host span has none
    assert outer["device_ms"] == outer["host_ms"] > 0
    assert outer["device_clock"] == "host"
    assert inner["device_ms"] is None and inner["device_clock"] is None


def test_a_span_closes_when_its_body_raises(spans_on):
    with pytest.raises(ValueError):
        with span("fails"):
            raise ValueError("body")
    with span("next"):
        pass
    recs = _by_name(span_records())
    assert recs["next"][0]["parent"] is None
    assert recs["fails"][0]["t1_ns"] >= recs["fails"][0]["t0_ns"]


def test_spans_share_the_profilers_clock(spans_on, tmp_path):
    """Each span is a user_annotation of the CPU profiler's Chrome trace,
    and its absolute start (ts * 1e3 + baseTimeNanoseconds) lies inside
    the span's own time_ns stamps (1 ms of room for a loaded worker)."""
    x = torch.arange(1 << 10)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with span(f"clock{i}"):
                x = x + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    found = {ev["name"]: ev for ev in trace["traceEvents"]
             if ev.get("cat") == "user_annotation"}
    recs = span_records()
    assert len(recs) == 20
    slack = 1_000_000
    for r in recs:
        ev = found[r["name"]]
        start = float(ev["ts"]) * 1e3 + base
        end = start + float(ev["dur"]) * 1e3
        assert r["t0_ns"] - slack <= start <= r["t1_ns"] + slack
        assert r["t0_ns"] - slack <= end <= r["t1_ns"] + slack


def test_trace_to_writes_the_spans_it_turned_on(tmp_path):
    with trace_to(str(tmp_path)):
        assert timing.spans_enabled()
        with span("traced", torch.device("cpu")):
            torch.arange(8).sum()
    assert not timing.spans_enabled()
    trace = json.loads(next(tmp_path.glob("trace.*.json")).read_text())
    assert [r["name"] for r in trace["programSpans"]] == ["traced"]
    assert any(ev.get("name") == "traced"
               and ev.get("cat") == "user_annotation"
               for ev in trace["traceEvents"])


def test_setup_build_spans_the_librarys_first_load(spans_on, monkeypatch):
    fake = types.SimpleNamespace(**{name: (lambda: 0)
                                    for name in _build._SIGNATURES})
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_compile", lambda: "libfake.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: fake)
    assert _build.library() is fake
    assert _build.library() is fake
    assert [r["name"] for r in span_records()] == ["setup.build"]


# ---- the program's spans ----------------------------------------------------

@pytest.mark.parametrize("use_fused", [True, False])
def test_ntt128_apply_spans_and_words(spans_on, use_fused):
    x = _words(4 << 8, 11)
    enable_spans(False)
    plain = AdditiveNTT128(8, 2, use_fused=use_fused, device="cpu").apply(x)
    assert span_records() == []
    enable_spans(True)
    ntt = AdditiveNTT128(8, 2, use_fused=use_fused, device="cpu")
    setup = span_records()
    assert [r["name"] for r in setup] == ["setup.tables"]
    set_request(0)
    got = ntt.apply(x)
    assert torch.equal(got, plain)
    recs = span_records()
    byname = _by_name(recs)
    (apply,) = byname["ntt.apply"]
    assert apply["parent"] is None
    for name in ("ntt.layout_in", "ntt.chain", "ntt.layout_out"):
        (r,) = byname[name]
        assert r["parent"] == apply["id"] and r["request"] == 0
        assert r["device_clock"] == "host"
    order = [r["name"] for r in recs if r["parent"] == apply["id"]]
    assert order == ["ntt.layout_in", "ntt.chain", "ntt.layout_out"]
    groups = byname.get("ntt.stage_group", [])
    if use_fused:
        chain = byname["ntt.chain"][0]["id"]
        assert len(groups) == len(ntt.tables) >= 1
        assert all(g["parent"] == chain for g in groups)
        assert [g["attrs"]["include_low"] for g in groups][-1] is True
        assert sum(g["attrs"]["include_low"] for g in groups) == 1
        assert not any(g["attrs"]["dplanes"] for g in groups)
        assert [(g["attrs"]["t0"], g["attrs"]["k"]) for g in groups] == [
            (t0, k) for t0, k, *_ in ntt.tables]
    else:
        assert groups == []


def test_ntt128_apply_sliced_opens_only_the_chain(spans_on):
    ntt = AdditiveNTT128(8, 2, device="cpu")
    span_records()
    x = _words(4 << 8, 12).view(-1, 128)
    ntt.apply_sliced(x)
    names = {r["name"] for r in span_records()}
    assert names == {"ntt.chain", "ntt.coset_copy", "ntt.stage_group"}


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("columns", [1, 3])
def test_ntt128_chain_counts_columns_and_holds_the_copy(spans_on, use_fused,
                                                        columns):
    """``ntt.chain`` carries its columns as an attribute and a count, and
    the one ``ntt.coset_copy`` of the call opens inside it, before the
    chain's kernels, on both routes; the words are those of a run with
    the spans off."""
    ntt = AdditiveNTT128(7, 1, use_fused=use_fused, device="cpu")
    x = _words(columns << 9, 15).view(columns, 4, 128)
    if columns == 1:
        x = x[0]
    enable_spans(False)
    plain = ntt.apply_sliced(x)
    enable_spans(True)
    span_records()
    set_request(5)
    assert torch.equal(ntt.apply_sliced(x), plain)
    recs = span_records()
    byname = _by_name(recs)
    (chain,) = byname["ntt.chain"]
    (copy,) = byname["ntt.coset_copy"]
    assert chain["parent"] is None and chain["request"] == 5
    assert chain["attrs"] == {"columns": columns}
    assert chain["counts"] == {"columns": columns}
    assert copy["parent"] == chain["id"] and copy["request"] == 5
    assert copy["device_clock"] == "host"
    inside = [r["name"] for r in recs if r["parent"] == chain["id"]]
    assert inside[0] == "ntt.coset_copy"
    assert set(inside) == ({"ntt.coset_copy", "ntt.stage_group"}
                           if use_fused else {"ntt.coset_copy"})


def _transcript(prover, rounds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        total, points = prover.round_messages()
        out.append(np.concatenate([total[None], points]))
        prover.move_to_next_round(rng.integers(0, 2 ** 32, 4,
                                               dtype=np.uint64))
    total, points = prover.round_messages()
    out.append(np.concatenate([total[None], points]))
    return np.stack(out)


def test_sumcheck_spans_and_words(spans_on):
    num_vars, comp = 8, 2
    evals = _words(4 * comp << num_vars, 13)
    enable_spans(False)
    plain = _transcript(Sumcheck(evals, comp, num_vars, device="cpu"),
                        num_vars, 5)
    enable_spans(True)
    set_request(3)
    got = _transcript(Sumcheck(evals, comp, num_vars, device="cpu"),
                      num_vars, 5)
    assert np.array_equal(got, plain)
    recs = span_records()
    byname = _by_name(recs)
    rounds = byname["sumcheck.round_messages"]
    assert len(rounds) == num_vars + 1
    assert len(byname["sumcheck.fold_launch"]) == num_vars
    for name in ("sumcheck.round_launch", "sumcheck.readback",
                 "sumcheck.message_sum"):
        assert len(byname[name]) == num_vars + 1
        assert all(_parent_name(r, recs) == "sumcheck.round_messages"
                   for r in byname[name])
    assert all(r["parent"] is None for r in rounds)
    assert all(r["parent"] is None for r in byname["sumcheck.fold_launch"])
    assert all(r["request"] == 3 and r["device_ms"] is None for r in recs)
    first = [r["name"] for r in recs if r["parent"] == rounds[0]["id"]]
    assert first == ["sumcheck.round_launch", "sumcheck.readback",
                     "sumcheck.message_sum"]


def test_sharded_ntt128_spans_counts_and_words(spans_on):
    log_h, log_rate, n_dev = 9, 2, 4
    data = _words(4 << log_h, 14).view(-1, 128)
    enable_spans(False)
    plain = ShardedAdditiveNTT128(log_h, log_rate,
                                  LocalMesh(n_dev, "cpu")).apply_sliced(data)
    enable_spans(True)
    mesh = LocalMesh(n_dev, "cpu")
    ntt = ShardedAdditiveNTT128(log_h, log_rate, mesh)
    assert [r["name"] for r in span_records()] == ["setup.tables"]
    xs = ntt.shard_input(data)
    out = ntt.gather_output(ntt.apply_shards(xs))
    assert torch.equal(out, plain)
    recs = span_records()
    byname = _by_name(recs)
    (top,) = byname["sharded.apply_shards"]
    (cross,) = byname["sharded.cross_stages"]
    assert cross["parent"] == top["id"]
    # every half of every shard on each of the log2(n_dev) cross stages
    halves = 2 * n_dev * OVERLAP_HALVES
    for name in ("sharded.exchange_wait", "sharded.cross_mul"):
        assert len(byname[name]) == halves
        assert all(r["parent"] == cross["id"] for r in byname[name])
    groups = byname["ntt.stage_group"]
    assert len(groups) == n_dev * len(ntt.groups)
    assert all(g["parent"] == top["id"] and g["attrs"]["dplanes"]
               for g in groups)
    # the counts are the mesh's, a whole shard of every device each stage
    shard_bytes = (1 << log_rate) * ntt.sb * 128 * 4
    assert cross["counts"] == {"exchanges": mesh.exchanges,
                               "exchange_bytes": mesh.exchange_bytes}
    assert mesh.exchange_bytes == 2 * n_dev * shard_bytes
    assert mesh.exchanges == 2 * n_dev * OVERLAP_HALVES


@pytest.mark.cuda
def test_device_spans_time_the_stream_on_the_card(spans_on):
    """On a CUDA device a span's device time is its event pair's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    x = torch.ones(1 << 24, device=dev)
    with span("card", dev):
        for _ in range(10):
            x = x * 1.0001
    torch.cuda.synchronize()
    (r,) = span_records()
    assert r["device_clock"] == "cuda_event" and r["device_ms"] > 0
