"""Auxiliary-particle-filter (-apf) test suite (VERDICT r3 item 3).

Covers:
- unit semantics of ``compute_lookahead`` against hand-built segments
  (reference: Segment::set_lookahead, segdata.cpp:225-410);
- no-data invariance: the lookahead enters the PILOT weight only and is
  divided back out at resampling, so with all data missing the posterior
  must equal the prior under -apf 1/2 (particleContainer.cpp:228-243);
- the feature's reason to exist: on missingness-heavy data the APF guides
  resampling toward particles compatible with upcoming variants
  (particle.cpp:439-617).
"""

import numpy as np
import pytest

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import EMConfig, run_chunk
from smcsmc_tpu.lookahead import _EPS, compute_lookahead
from smcsmc_tpu.segio import SegData
from smcsmc_tpu.simulate import simulate_seg


def _seg(rows, n, phased=None):
    """rows: list of (pos, length, alleles list)."""
    pos = np.array([r[0] for r in rows], dtype=np.int64)
    ln = np.array([r[1] for r in rows], dtype=np.int64)
    al = np.array([r[2] for r in rows], dtype=np.int8)
    return SegData(
        positions=pos,
        lengths=ln,
        states=np.zeros(len(rows), dtype=np.int8),
        alleles=al,
        phased=np.ones(n, bool) if phased is None else np.asarray(phased),
    )


def _demo(L=1e6, n=4, ne=10000.0):
    return Demography(
        change_times=np.array([0.0]),
        pop_sizes=np.array([[ne]]),
        mig_rates=np.zeros((1, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )


class TestComputeLookahead:
    """Hand-built segment scans (segdata.cpp:225-410 semantics)."""

    def test_first_singleton_distances(self):
        # seg rows: invariant, singleton(leaf0), doubleton(1,2), singleton(3)
        seg = _seg(
            [
                (0, 100, [0, 0, 0, 0]),
                (100, 200, [1, 0, 0, 0]),
                (300, 300, [0, 1, 1, 0]),
                (600, 400, [0, 0, 0, 1]),
            ],
            n=4,
        )
        la = compute_lookahead(seg)
        # from segment 0 (base 0): leaf 0's first singleton ends at
        # 100+200 (+0.5 half-open correction, segdata.cpp:316)
        assert la.fsd[0, 0] == pytest.approx(300.5)
        # leaf 3's singleton is the last row
        assert la.fsd[0, 3] == pytest.approx(1000.5)
        # leaves 1,2 see only the shared doubleton, never a singleton:
        # negative distance = "none seen within |d|" (segdata.cpp:389-396)
        assert la.fsd[0, 1] == pytest.approx(-1000.5)
        assert la.fsd[0, 2] == pytest.approx(-1000.5)
        # complete data: relative mutation rate is exactly 1
        np.testing.assert_allclose(la.rel_mu[0], 1.0)
        # scans from later segments shift the base
        assert la.fsd[1, 0] == pytest.approx(200.5)

    def test_doubleton_evidence(self):
        seg = _seg(
            [
                (0, 100, [0, 0, 0, 0]),
                (100, 200, [0, 1, 1, 0]),  # doubleton (1,2) first evidence
                (300, 300, [0, 1, 1, 0]),  # repeated: last evidence moves
                (600, 400, [0, 0, 0, 0]),
            ],
            n=4,
        )
        la = compute_lookahead(seg)
        assert la.dbl_s1[0, 0] == 1 and la.dbl_s2[0, 0] == 2
        assert la.dbl_first[0, 0] == pytest.approx(300.5)
        assert la.dbl_last[0, 0] == pytest.approx(600.5)
        # only one doubleton entered
        assert la.dbl_s1[0, 1] == -1

    def test_incompatible_variant_freezes_last_evidence(self):
        """A later variant carrying exactly one of the pair is incompatible
        with the cherry: last_evidence freezes (segdata.cpp:338-357)."""
        seg = _seg(
            [
                (0, 100, [0, 0, 0, 0]),
                (100, 200, [0, 1, 1, 0]),  # doubleton (1,2), evidence 300.5
                (300, 300, [0, 1, 0, 1]),  # splits the pair -> incompatible
                (600, 400, [0, 1, 1, 0]),  # same pair again: frozen
            ],
            n=4,
        )
        la = compute_lookahead(seg)
        assert la.dbl_s1[0, 0] == 1 and la.dbl_s2[0, 0] == 2
        assert la.dbl_last[0, 0] == pytest.approx(300.5)  # NOT 1000.5

    def test_phasing_aware_incompatibility(self):
        """A non-singleton variant with an unphased het (code 2) on a
        cherry's diploid individual marks that doubleton incompatible
        (segdata.cpp:338-344: (s1|1)==s2 and a[s1]==2).  A bare het row
        [2,2,0,0] counts as a SINGLETON (segdata.cpp:270-278 skips the pair
        partner) and must NOT trigger the check."""
        seg = _seg(
            [
                (0, 100, [1, 1, 0, 0]),  # doubleton on individual 0's pair
                (100, 200, [2, 2, 1, 0]),  # het on the pair + carrier 2
                (300, 300, [1, 1, 0, 0]),  # same pair again: frozen
            ],
            n=4,
            phased=[False, False, True, True],
        )
        la = compute_lookahead(seg)
        assert la.dbl_s1[0, 0] == 0 and la.dbl_s2[0, 0] == 1
        assert la.dbl_last[0, 0] == pytest.approx(100.5)  # frozen at entry
        # control: the bare-het row is a singleton, not an incompatibility
        seg2 = _seg(
            [
                (0, 100, [1, 1, 0, 0]),
                (100, 200, [2, 2, 0, 0]),  # singleton (unphased)
                (300, 300, [1, 1, 0, 0]),
            ],
            n=4,
            phased=[False, False, True, True],
        )
        la2 = compute_lookahead(seg2)
        assert la2.dbl_last[0, 0] == pytest.approx(600.5)  # still moving

    def test_unphased_singleton_mirrors_to_partner(self):
        """An unphased singleton (code 2) could sit on either haplotype of
        the pair: both get the distance, the even index is flagged
        (segdata.cpp:322-334)."""
        seg = _seg(
            [
                (0, 100, [0, 0, 0, 0]),
                (100, 200, [2, 2, 0, 0]),
                (300, 100, [0, 0, 1, 0]),
            ],
            n=4,
            phased=[False, False, True, True],
        )
        la = compute_lookahead(seg)
        assert la.unphased[0, 0]
        assert la.fsd[0, 0] == pytest.approx(300.5)
        assert la.fsd[0, 1] == pytest.approx(300.5)

    def test_first_split(self):
        """First variant with >2 carriers and >2 non-carriers records the
        split distance, alleles, and minor count (segdata.cpp:375-380)."""
        n = 6
        seg = _seg(
            [
                (0, 100, [0] * n),
                (100, 200, [1, 1, 1, 0, 0, 0]),
                (300, 100, [0] * n),
            ],
            n=n,
        )
        la = compute_lookahead(seg)
        assert la.split_dist[0] == pytest.approx(300.5)
        assert la.split_k[0] == 3
        np.testing.assert_array_equal(
            la.split_alleles[0], [1, 1, 1, 0, 0, 0]
        )
        # a 4-leaf panel cannot have a split (needs >2 on both sides)
        seg4 = _seg([(0, 100, [1, 1, 0, 0])], n=4)
        assert compute_lookahead(seg4).split_dist[0] == -1.0

    def test_missing_data_lowers_rel_mu(self):
        seg = _seg(
            [
                (0, 100, [0, -1, 0, 0]),
                (100, 200, [1, -1, 0, 0]),
            ],
            n=4,
        )
        la = compute_lookahead(seg)
        # leaf 0's singleton: rel_mu = tlbm/tlb < 1 because lineage 1 was
        # missing over the scanned span (segdata.cpp:307-317)
        assert 0.5 < la.rel_mu[0, 0] < 1.0

    def test_long_missing_streak_gives_up(self):
        """> 2 Mb of consecutive missing data on a lineage sets
        first-singleton distance to -epsilon (segdata.cpp:288-300)."""
        seg = _seg(
            [
                (0, 1_500_000, [0, -1, 0, 0]),
                (1_500_000, 1_500_000, [0, -1, 0, 0]),
                (3_000_000, 100, [0, 1, 0, 0]),
            ],
            n=4,
        )
        la = compute_lookahead(seg)
        assert la.fsd[0, 1] == pytest.approx(-_EPS)


class TestNativeLookahead:
    """The C scanner (native/lookahead.c) against the Python oracle."""

    def test_native_matches_oracle(self):
        from smcsmc_tpu.lookahead import (
            _native_lookahead,
            compute_lookahead_py,
        )

        # built from native/lookahead.c on first use
        assert _native_lookahead() is not None
        demo = _demo(n=8, L=5e5)
        demo.sample_pops = np.zeros(8, dtype=np.int32)
        seg = simulate_seg(demo, seed=43)
        # punch in missing windows and unphase a pair to cover every branch
        al = seg.alleles.copy()
        al[(seg.positions // 50_000) % 3 == 1, 2] = -1
        het = (al[:, 0] + al[:, 1] == 1) & (al[:, 0] >= 0)
        al[het, 0] = 2
        al[het, 1] = 2
        seg = SegData(positions=seg.positions, lengths=seg.lengths,
                      states=seg.states, alleles=al,
                      phased=np.array([False, False] + [True] * 6))
        la_c = compute_lookahead(seg)
        la_p = compute_lookahead_py(seg)
        for f in la_c.__dataclass_fields__:
            np.testing.assert_allclose(
                np.asarray(getattr(la_c, f), np.float64),
                np.asarray(getattr(la_p, f), np.float64),
                rtol=1e-6, atol=1e-6, err_msg=f,
            )


@pytest.mark.slow
class TestAPFNoDataInvariance:
    @pytest.mark.parametrize("apf", [1, 2])
    def test_posterior_equals_prior(self, apf):
        """The lookahead likelihood enters the pilot only and is divided
        back out at resampling (particleContainer.cpp:228-243): with all
        data missing the posterior must equal the coalescent prior."""
        ne = 10000.0
        demo = _demo(ne=ne, n=4, L=1e6)
        n_seg = 40
        seg = SegData(
            positions=1 + np.arange(n_seg) * 25000,
            lengths=np.full(n_seg, 25000),
            states=np.zeros(n_seg, dtype=np.int8),
            alleles=np.full((n_seg, 4), -1, dtype=np.int8),
            phased=np.ones(4, bool),
        )
        cfg = EMConfig(
            num_particles=300, block_size=64, lag=20000.0, apf=apf,
            apf_trees=20000,
            # with no data the lookahead is uninformative, so the pilot ESS
            # never crosses a sane threshold; force resampling at EVERY
            # segment so the APF divide-back-out path actually executes
            ess_threshold=1.01,
        )
        stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=4)
        assert diag["num_resamples"] > 0
        assert logl == pytest.approx(0.0, abs=0.8)
        ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
        assert ne_hat == pytest.approx(ne, rel=0.08)


@pytest.mark.slow
class TestAPFGuidesResampling:
    def test_lookahead_differentiates_pilot_from_posterior(self):
        """On real data with missing stretches the lookahead must actually
        move the resampling criterion: the pilot ESS trace under -apf 2
        differs from -apf 0, while the posterior estimates stay consistent
        (the APF reweight compensates — particle.cpp:439-617's contract)."""
        demo = _demo(n=4, L=8e5)
        seg = simulate_seg(demo, seed=51)
        # punch missing windows into the data (missingness-heavy scenario)
        al = seg.alleles.copy()
        pos = seg.positions
        miss = (pos // 100_000) % 2 == 1
        al[miss] = -1
        seg = SegData(
            positions=seg.positions, lengths=seg.lengths,
            states=seg.states, alleles=al, phased=seg.phased,
        )
        res = {}
        for apf in (0, 2):
            cfg = EMConfig(num_particles=200, block_size=128, apf=apf,
                           apf_trees=20000, lag=20000.0)
            stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=9)
            ne_hat = float(
                stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum())
            )
            res[apf] = (np.asarray(diag["ess"]), logl, ne_hat)
        ess0, logl0, ne0 = res[0]
        ess2, logl2, ne2 = res[2]
        # the lookahead reshapes the pilot ESS trace (it is the resampling
        # criterion under APF)
        assert not np.allclose(ess0[: len(ess2)], ess2[: len(ess0)])
        # both remain valid estimators of the same posterior
        assert np.isfinite(logl2)
        assert ne2 == pytest.approx(ne0, rel=0.35)
