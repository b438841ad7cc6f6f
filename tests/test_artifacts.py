"""Golden-artifact completeness and consistency gates: a committed
artifact must not ship holes where its own schema promises statistics,
and one named statistic runs across prose and JSON.

These tests run on CPU in seconds: they validate the COMMITTED
artifacts — schema completeness, internal consistency, and that the
headline statistics reproduce from the committed curve dumps — not the
simulations that produced them (those are the gpu-marked golden tests
and the scripts/golden_*.py instruments).
"""

import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(REPO, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not committed")
    with open(path) as f:
        return json.load(f)


class TestPairedArtifacts:
    """GOLDEN_T2_FULL / _P / _intended — golden_paired.py products."""

    @pytest.mark.parametrize("name,npz", [
        ("GOLDEN_T2_FULL.json", "GOLDEN_T2_FULL_curves.npz"),
        ("GOLDEN_T2_P.json", "GOLDEN_T2_P_curves.npz"),
        ("GOLDEN_T2_FULL_intended.json",
         "GOLDEN_T2_FULL_intended_curves.npz"),
    ])
    def test_stats_reproduce_from_curves(self, name, npz):
        rep = _load(name)
        z = np.load(os.path.join(REPO, npz))
        oracle, ours = z["oracle"], z["framework"]
        n = min(oracle.shape[1], ours.shape[1])
        d = oracle[:, :n] - ours[:, :n]
        mean_d = d.mean(0)
        se = d.std(0, ddof=1) / np.sqrt(len(d))
        assert rep["config"]["paired_scenes"] == len(d)
        assert abs(rep["rms_diff"]
                   - float(np.sqrt(np.mean(mean_d ** 2)))) < 1e-9
        assert abs(rep["rms_expected_under_h0"]
                   - float(np.sqrt(np.mean(se ** 2)))) < 1e-9
        t = mean_d / np.maximum(se, 1e-12)
        assert abs(rep["max_abs_t_paired"] - np.abs(t).max()) < 1e-6
        # the old ambiguous name must not reappear
        assert "max_abs_z" not in rep
        assert "t_paired" in rep["stat_definition"]

    def test_intended_arm_parity(self):
        rep = _load("GOLDEN_T2_FULL_intended.json")
        assert rep["config"]["kick"] == "intended"
        assert rep["config"]["paired_scenes"] >= 3
        # deep decay reached and the two independent implementations of
        # the corrected physics agree within ~the H0 envelope
        assert rep["curve_min"] < 0.45
        assert rep["rms_ratio"] < 2.0

    def test_full_arm_residual_unchanged(self):
        """The attributed residual's scale is pinned: a silently
        regenerated artifact with a larger residual must fail review."""
        rep = _load("GOLDEN_T2_FULL.json")
        assert rep["rms_diff"] < 0.02
        assert abs(rep["final_diff"]) < 0.04


class TestDispersionArtifact:
    def test_no_null_statistics(self):
        rep = _load("GOLDEN_DISPERSION.json")
        for tcp, row in rep["per_tcp"].items():
            assert row["paired_scenes"] >= 4, (tcp, row["paired_scenes"])
            for key in ("rms_diff", "rms_expected_under_h0", "rms_ratio",
                        "max_abs_t_paired", "r2_mean_diff", "r2_diff_se"):
                assert row[key] is not None, (tcp, key)
        rec = rep["reconstruction_consistency"]
        assert rec["r2_diff_spread_per_ms"] is not None
        assert rec["r2_diff_spread_se_per_ms"] is not None

    def test_reconstruction_covers_all_spacings(self):
        rep = _load("GOLDEN_DISPERSION.json")
        spacings = {str(t) for t in rep["config"]["spacings"]}
        assert spacings == set(rep["per_tcp"])
        flags = {t: rep["per_tcp"][t]["reconstructed"] for t in spacings}
        base = str(rep["config"]["base_tcp"])
        assert flags.pop(base) is False
        assert all(flags.values())


class TestAttributionArtifact:
    def test_tightening_experiment_populated(self):
        """The decisive zero-noise experiment must
        carry measured per-seed deltas, not an empty dict."""
        rep = _load("GOLDEN_T2_FULL_ATTRIBUTION.json")
        per_seed = rep["oracle_octree_tightening"]["per_seed"]
        assert len(per_seed) >= 2
        s0 = per_seed["6000"]
        assert "tight5e-7_minus_coarse" in s0
        assert "exact_minus_coarse_str4" in s0
        concl = rep["oracle_octree_tightening"]["conclusion"]
        assert concl["monotone_toward_framework"] is True

    def test_residual_is_explained(self):
        """The exact-field endpoint (zero walker noise) must account
        for the bulk of the FULL-arm residual, and the framework's own
        field error must stay negligible."""
        rep = _load("GOLDEN_T2_FULL_ATTRIBUTION.json")
        fw = rep["framework_field_error_same_streams"]
        assert fw["rms"] < 1e-3
        endpoint = rep["oracle_octree_tightening"]["conclusion"][
            "exact_endpoint"]
        seeds = [k for k in endpoint if k != "note"]
        assert len(seeds) >= 2
        for s in seeds:
            frac = endpoint[s][
                "explained_fraction_of_residual_late_window"]
            # measured 1.08 / 0.95 on seeds 6000 / 6001; the window
            # tolerates stride-subset sampling of the systematic
            assert 0.6 < frac < 1.6, (s, frac)


class TestGradientArtifact:
    def test_gradient_arm_committed(self):
        rep = _load("GOLDEN_T2_G.json")
        assert rep["config"]["gradient_z"]
        assert rep["config"]["paired_scenes"] >= 3
        assert rep["rms_ratio"] is not None
