"""Autotuners for the staged pipelines' node chunk and the ds sub-batch
(timing-probe wisdom)."""

import json

import pytest

import boltzfft as bz
from boltzfft import tune


def small_cfg(**kw):
    kw.setdefault("nv", 8)
    kw.setdefault("ns", 6)
    kw.setdefault("n_radial", 4)
    kw.setdefault("impl", "rfft")
    kw.setdefault("dtype", "float32")
    return bz.CollisionConfig(**kw)


class TestAutotune:
    def test_candidates_are_deduplicated(self):
        cfg = small_cfg(nv=16, ns=12)
        cands = tune._chunk_candidates(cfg)
        assert len(cands) >= 1
        # candidates normalize to distinct effective chunks
        import dataclasses

        eff = [dataclasses.replace(cfg, node_chunk=c).chunk for c in cands]
        assert len(set(eff)) == len(eff)
        assert all(1 <= c <= cfg.n_nodes for c in eff)

    def test_picks_fastest_and_memoizes(self, monkeypatch, tmp_path):
        cfg = small_cfg()
        fake_times = {3: 2.0, 6: 0.5, 12: 1.0}
        calls = []

        def fake_time(trial_cfg, k, trials):
            calls.append(trial_cfg.node_chunk)
            return fake_times.get(trial_cfg.node_chunk, 3.0)

        monkeypatch.setattr(tune, "_time_candidate", fake_time)
        tune._MEMO.clear()
        cache = tmp_path / "wisdom.json"
        tuned = bz.autotune(cfg, candidates=[3, 6, 12], cache_file=str(cache))
        assert tuned.node_chunk == 6
        assert len(calls) == 3

        # memoized: no further probing
        calls.clear()
        assert bz.autotune(cfg, candidates=[3]).node_chunk == 6
        assert calls == []

        # disk cache survives a fresh process (cleared memo)
        tune._MEMO.clear()
        tuned3 = bz.autotune(cfg, candidates=[3], cache_file=str(cache))
        assert tuned3.node_chunk == 6
        assert calls == []
        assert json.loads(cache.read_text())

    def test_failing_candidate_skipped(self, monkeypatch):
        cfg = small_cfg()

        def fake_time(trial_cfg, k, trials):
            if trial_cfg.node_chunk == 3:
                raise RuntimeError("out of memory")
            return 1.0

        monkeypatch.setattr(tune, "_time_candidate", fake_time)
        tune._MEMO.clear()
        assert bz.autotune(cfg, candidates=[3, 6]).node_chunk == 6

    @pytest.mark.parametrize("impl", ["c2c", "dft"])
    def test_memo_keyed_by_impl(self, monkeypatch, impl):
        # a winner for one pipeline is never reused for another
        monkeypatch.setattr(tune, "_time_candidate",
                            lambda c, k, t: 1.0 / c.node_chunk)
        tune._MEMO.clear()
        assert bz.autotune(small_cfg(), candidates=[4]).node_chunk == 4
        assert bz.autotune(small_cfg(impl=impl),
                           candidates=[2]).node_chunk == 2


class TestStagedAutotune:
    def test_node_chunk_probe_and_wisdom(self, tmp_path):
        import boltzfft as bz

        wisdom = tmp_path / "wisdom.json"
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft",
                                 dtype="float32")
        tuned = bz.autotune(cfg, k=1, trials=1, cache_file=str(wisdom))
        assert tuned.node_chunk is not None
        assert tuned.chunk <= cfg.n_nodes
        # memoized: second call returns instantly with the same winner
        tuned2 = bz.autotune(cfg, k=1, trials=1, cache_file=str(wisdom))
        assert tuned2.node_chunk == tuned.node_chunk
        assert wisdom.exists()
        # wisdom survives a cleared in-process memo
        from boltzfft import tune
        tune._MEMO.clear()
        tuned3 = bz.autotune(cfg, k=1, trials=1, cache_file=str(wisdom))
        assert tuned3.node_chunk == tuned.node_chunk


class TestDsAutotune:
    def test_sub_batch_probe(self, tmp_path):
        import boltzfft as bz

        wisdom = tmp_path / "wisdom.json"
        cfg = bz.CollisionConfig(nv=4, ns=6, n_radial=2, impl="c2c",
                                 dtype="float32")
        sb = bz.autotune_ds(cfg, candidates=[3], k=1, trials=1,
                            cache_file=str(wisdom))
        assert sb == 3
        from boltzfft import tune
        tune._MEMO.clear()
        assert bz.autotune_ds(cfg, candidates=[3], k=1, trials=1,
                              cache_file=str(wisdom)) == sb
