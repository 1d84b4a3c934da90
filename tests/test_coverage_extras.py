"""Coverage for secondary capability paths: TICA/VAMP dimreduce, weighted
clustering, multi-file datasets, seg histories, correlation functions,
adaptive FPT distributions, fundamental sequences."""
import numpy as np
import pytest

from msm_we_tpu.binning import RectilinearBinMapper, VoronoiBinMapper
from msm_we_tpu.data import WEDataset, generate_west_h5
from msm_we_tpu.model import modelWE
from msm_we_tpu.msm.fpt import MatrixFPT
from msm_we_tpu.msm.nmm import NonMarkovModel
from msm_we_tpu.utils import random_markov_matrix


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wemulti")
    f1 = str(d / "west1.h5")
    f2 = str(d / "west2.h5")
    generate_west_h5(f1, n_iterations=25, n_segments=16, seed=31)
    generate_west_h5(f2, n_iterations=25, n_segments=16, seed=32)
    return [f1, f2]


def _build(files, dimreduce, **kwargs):
    model = modelWE()
    model.initialize(
        files,
        {"coords": None, "nAtoms": 4, "coord_ndim": 3},
        "extras",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dim_reduce_method=dimreduce,
        tau=1.0,
        **kwargs,
    )
    model.get_iterations()
    model.get_coordSet(model.maxIter)
    model.dimReduce()
    return model


def test_multi_file_dataset(two_files):
    """Segments of an iteration spread over two files merge correctly."""
    ds = WEDataset(two_files)
    assert ds.maxIter == 25
    d = ds.iter_data(3)
    assert d["n_segs"] > 16  # both files contribute
    assert set(np.unique(d["west_idx"])) == {0, 1}
    # Weights from two independent runs: each sums to 1
    w0 = d["weights"][d["west_idx"] == 0].sum()
    w1 = d["weights"][d["west_idx"] == 1].sum()
    assert np.isclose(w0, 1.0) and np.isclose(w1, 1.0)


def test_multi_file_model_build(two_files):
    model = _build(two_files, "pca")
    mapper = RectilinearBinMapper([np.linspace(0, 10, 11)])
    model.cluster_coordinates(n_clusters=2, stratified=True, user_bin_mapper=mapper)
    model.get_fluxMatrix(0)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    assert model.JtargetSS > 0


@pytest.mark.parametrize("method", ["tica", "vamp", "batch-pca"])
def test_dimreduce_methods(two_files, method):
    model = _build(two_files[:1], method)
    assert model.ndim >= 1
    if method == "batch-pca":
        # Reference batch-pca keeps ALL components (sklearn PCA(n_components=None))
        assert model.ndim == 4 * 3
    coords = model._dataset.iter_child_coords(2)
    reduced = model.reduceCoordinates(coords)
    assert reduced.shape == (len(coords), model.ndim)


def test_weighted_clustering(two_files):
    model = _build(two_files[:1], "none", use_weights_in_clustering=True)
    mapper = VoronoiBinMapper(np.linspace(0.5, 9.5, 8)[:, None])
    model.cluster_coordinates(n_clusters=2, stratified=True, user_bin_mapper=mapper)
    model.get_fluxMatrix(0)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    assert np.isclose(model.pSS.sum(), 1.0)


def test_get_coordSet_nonstreaming(two_files):
    model = _build(two_files[:1], "none")
    model.get_coordSet(model.maxIter, streaming=False)
    assert model.all_coords.shape[0] == model.pcoordSet.shape[0]
    assert model.all_coords.shape[1:] == (4, 3)


def test_seg_histories(two_files):
    model = _build(two_files[:1], "none")
    model.load_iter_data(10)
    model.get_seg_histories(5)
    assert model.seg_histories.shape == (model.nSeg, 5)
    assert model.weight_histories.shape == (model.nSeg, 5)
    # Weights along a history are positive wherever the ancestry is unbroken
    live = model.seg_histories >= 0
    assert (model.weight_histories[live[:, :5]] >= 0).all()


def test_transition_data_lag0_compat(two_files):
    model = _build(two_files[:1], "none")
    model.load_iter_data(5)
    model.get_transition_data_lag0()
    assert model.coordPairList.shape == (model.nSeg, 4, 3, 2)
    assert np.array_equal(model.transitionWeights, model.departureWeights)


def test_nlag_guard(two_files):
    """Negative lags rejected; lag > 0 is now a supported extension (the
    reference raises for any lag != 0, ``msm_we.py:353-359``)."""
    model = _build(two_files[:1], "none")
    with pytest.raises(ValueError):
        model.n_lag = -1
    model.n_lag = 1
    assert model.n_lag == 1
    model.n_lag = 0


def test_deprecated_compat_paths(two_files):
    """Space-separated fileSpecifier strings and the WE*p1_bounds aliases."""
    model = modelWE()
    model.initialize(
        two_files[0],  # plain string (deprecated single-file form)
        {"coords": None, "nAtoms": 4, "coord_ndim": 3},
        "compat",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dim_reduce_method="none",
        tau=1.0,
    )
    assert model.fileList == [two_files[0]]
    # Deprecated 1-D aliases delegate to the N-D properties
    assert np.allclose(model.WEbasisp1_bounds, [[9.0, 10.0]])
    assert np.allclose(model.WEtargetp1_bounds, [[0.0, 1.0]])
    model.WEbasisp1_bounds = [[8.5, 10.0]]
    assert np.allclose(model.basis_pcoord_bounds, [[8.5, 10.0]])
    assert np.isclose(model.basis_bin_centers[0], 9.25)


def test_pcoord_len_gt2(tmp_path):
    """Datasets with more than 2 pcoord frames use frames 0 and -1."""
    from msm_we_tpu.data.synthetic import SynthWESettings, generate_west_h5

    path = str(tmp_path / "long.h5")
    generate_west_h5(
        path,
        settings=SynthWESettings(
            n_iterations=11, n_segments=12, pcoord_len=5, seed=3, warmup=5
        ),
    )
    from msm_we_tpu.data import WEDataset

    ds = WEDataset([path])
    assert ds.maxIter == 10
    d = ds.iter_data(3)
    import h5py

    with h5py.File(path) as h5:
        pc = h5["iterations/iter_00000003/pcoord"][:]
    assert pc.shape[1] == 5
    assert np.allclose(d["pcoord0"][:, 0], pc[:, 0, 0])
    assert np.allclose(d["pcoord1"][:, 0], pc[:, -1, 0])


def test_equilibrium_tmatrix(two_files):
    """get_eqTmatrix drops basis/target and row-normalizes (reference
    ``_analysis.py:81-95``)."""
    model = _build(two_files[:1], "none")
    mapper = RectilinearBinMapper([np.linspace(0, 10, 11)])
    model.cluster_coordinates(n_clusters=2, stratified=True, user_bin_mapper=mapper)
    model.get_fluxMatrix(0)
    model.organize_fluxMatrix()
    model.get_eqTmatrix()
    T = model.Tmatrix
    assert T.shape == (model.nBins - 2, model.nBins - 2)
    assert np.allclose(T.sum(axis=1), 1.0)
    # Equilibrium steady state from this matrix
    pss = model.get_steady_state_algebraic(set=False)
    assert np.isclose(pss.sum(), 1.0)


def test_corr_function():
    np.random.seed(5)
    trajs = [np.random.randint(0, 3, 20000)]
    m = NonMarkovModel(trajs, stateA=[0], stateB=[2], lag_time=1)
    pAA, pAB, pBA, pBB = m.corr_function([1, 5, 10])
    # For an uncorrelated random walk these converge to pA*pA etc
    pops = m.populations()
    assert np.isclose(pAA[-1], pops[0] ** 2, atol=0.01)
    assert len(pAA) == 3


def test_markovian_mode():
    np.random.seed(6)
    trajs = [np.random.randint(0, 3, 20000)]
    m = NonMarkovModel(trajs, stateA=[0], stateB=[2], lag_time=1, markovian=True)
    mfpts = m.mfpts()
    assert mfpts["mfptAB"] > 0 and np.isfinite(mfpts["mfptAB"])
    assert np.isclose(sum(m.populations()), 1.0)
    assert 0 < m.popA < 1 and 0 < m.popB < 1


def test_weighted_fundamental_sequences():
    np.random.seed(7)
    trajs = [np.random.randint(0, 4, 5000)]
    m = NonMarkovModel(trajs, stateA=[0], stateB=[3], lag_time=1)
    fs, weights, n = m.empirical_weighted_FS()
    assert np.isclose(sum(weights), 1.0)
    assert all(seq[0] in m.stateA or True for seq in fs)

    fs2, weights2, n2 = m.weighted_FS(n_paths=50)
    assert n2 == 50
    assert np.isclose(sum(weights2), 1.0)


def test_adaptive_fpt_distribution():
    T = random_markov_matrix(6, seed=4)
    probs, all_probs, last, times = MatrixFPT.adaptive_fpt_distribution(
        T, [0], [1.0], [5], max_steps=200
    )
    assert np.isclose(probs.sum(), 1.0, atol=1e-6)
    assert len(times) >= last


def test_fpt_distribution_multiple_targets():
    T = random_markov_matrix(6, seed=8)
    dist = MatrixFPT.fpt_distribution(T, [0], [4, 5], [1.0], max_n_lags=20)
    assert np.isclose(dist[:, 1].sum(), 1.0)
    assert dist.shape == (21, 2)


def test_from_transition_matrix_generators():
    from msm_we_tpu.msm.ensembles import DiscreteEnsemble

    np.random.seed(9)
    T = random_markov_matrix(4, seed=9)
    ens = DiscreteEnsemble.from_transition_matrix(T, sim_length=500)
    assert len(ens[0]) == 501

    np.random.seed(10)
    nm = NonMarkovModel.from_nm_tmatrix(
        np.kron(T, np.eye(2) * 0 + 0.5), [0], [3], sim_length=200
    )
    assert nm.n_states >= 1


def test_device_moments_pca_matches_host(two_files):
    """dimReduce(device_moments=True) (f32 per-batch moments, f64 Chan
    combine) must reproduce the exact host-f64 PCA to f32-batch tolerance."""
    host = _build(two_files[:1], "pca")
    host.dimReduce(device_moments=False)
    dev = _build(two_files[:1], "pca")
    dev.dimReduce(device_moments=True)

    assert dev.ndim == host.ndim
    np.testing.assert_allclose(
        dev.coordinates.covariance_, host.coordinates.covariance_,
        rtol=1e-4, atol=1e-6,
    )
    coords = host._dataset.iter_child_coords(3)
    a = host.reduceCoordinates(coords)
    b = dev.reduceCoordinates(coords)
    # components may differ by sign
    for j in range(host.ndim):
        assert np.allclose(a[:, j], b[:, j], atol=1e-3) or np.allclose(
            a[:, j], -b[:, j], atol=1e-3
        )


def test_dimreduce_n_components_keeps_that_many(two_files):
    """dimReduce(n_components=k) keeps exactly the k leading components of
    the same PCA fit the variance cutoff draws from."""
    cut = _build(two_files[:1], "pca")
    fixed = _build(two_files[:1], "pca")
    fixed.dimReduce(n_components=5)
    assert fixed.ndim == 5
    k = min(cut.ndim, 5)
    np.testing.assert_array_equal(
        fixed.coordinates.components_[:k], cut.coordinates.components_[:k]
    )
    coords = fixed._dataset.iter_child_coords(2)
    assert fixed.reduceCoordinates(coords).shape == (len(coords), 5)


@pytest.mark.parametrize("method", ["tica", "batch-pca", "none"])
def test_dimreduce_n_components_is_pca_only(two_files, method):
    model = _build(two_files[:1], method)
    with pytest.raises(ValueError, match="n_components"):
        model.dimReduce(n_components=3)


@pytest.mark.parametrize("offset", [0.0, 1e7])
def test_pca_device_projection_matches_f64(offset):
    """PCAModel.transform above _DEVICE_TRANSFORM_MIN_FLOPS (the jitted
    ``_project``) agrees with the host route and with numpy f64, for
    centred data and for far-from-origin data (no folded offset)."""
    from msm_we_tpu.ops.pca import _DEVICE_TRANSFORM_MIN_FLOPS, PCAModel

    rng = np.random.default_rng(5)
    d, k = 300, 30
    comps = np.linalg.qr(rng.normal(size=(d, k)))[0].T
    mean = rng.normal(size=d) + offset
    pca = PCAModel(mean, comps, np.linspace(2.0, 1.0, k))
    X = mean + rng.normal(size=(4096, d))
    assert 2.0 * X.size * k >= _DEVICE_TRANSFORM_MIN_FLOPS
    want = (X - mean) @ comps.T
    big = pca.transform(X)
    small = np.concatenate([pca.transform(X[i : i + 64]) for i in range(0, 256, 64)])
    assert 2.0 * 64 * d * k < _DEVICE_TRANSFORM_MIN_FLOPS
    scale = np.abs(want).max()
    assert pca._fold_ok == (offset == 0.0)
    assert np.abs(big - want).max() / scale < 1e-5
    np.testing.assert_allclose(big[:256], small, rtol=0, atol=1e-5 * scale)
