"""Postselection and reference samples of the port's detector sampler.

Mirrors ``tests/unit/test_postselection.py`` on programs with components:
the ``MIXED`` circuits of that file, compiled by tsim_tpu and exported in
process, and the committed 2-check cultivation program. Then holds the
port against tsim_tpu: with the noise rows fixed and tsim_tpu's draw
uniforms injected, every output bit of a postselected run is equal (exact
mode on both sides, tsim_tpu evaluating exactly on the CPU); the port's
reference sample equals tsim_tpu's on every output that is deterministic
without noise. A fully-direct program ignores the mask, as tsim_tpu's does,
and gives tsim_tpu's bits; it raises on a mask of the wrong shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsim_tpu
from dev.export_torch_program import export_sampler
from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.models.exported import cultivation_d3

# One direct detector (rate 0.3), one quantum (T-gate) detector + observable.
MIXED = """
X_ERROR(0.3) 0
M 0
DETECTOR rec[-1]
H 1
T 1
X_ERROR(0.1) 1
H 1
M 1
DETECTOR rec[-1]
OBSERVABLE_INCLUDE(0) rec[-1]
"""

DIRECT_ONLY = """
X_ERROR(0.3) 0
X_ERROR(0.2) 1
M 0 1
DETECTOR rec[-2]
DETECTOR rec[-1]
OBSERVABLE_INCLUDE(0) rec[-1]
"""

ALWAYS_DISCARD = """
X_ERROR(1) 0
M 0
DETECTOR rec[-1]
H 1
T 1
X_ERROR(0.1) 1
H 1
M 1
DETECTOR rec[-1]
"""

# Direct detector + direct observable + quantum detector.
DIRECT_OBS_MIXED = """
X_ERROR(0.3) 0
M 0
DETECTOR rec[-1]
X_ERROR(0.1) 1
M 1
OBSERVABLE_INCLUDE(0) rec[-1]
H 2
T 2
X_ERROR(0.1) 2
H 2
M 2
DETECTOR rec[-1]
"""

FLIPPED = "X 0\n" + MIXED  # detector 0's reference value is 1
DETERMINISTIC_OBS = MIXED + "X 2\nM 2\nOBSERVABLE_INCLUDE(1) rec[-1]\n"


@functools.lru_cache(maxsize=None)
def _reference(text):
    return tsim_tpu.Circuit(text).compile_detector_sampler(seed=0)


@functools.lru_cache(maxsize=None)
def _exported(text):
    return export_sampler(_reference(text))


def _sampler(text=MIXED, seed=0, evaluation="f32"):
    return port_sampler.CompiledDetectorSampler(
        _exported(text), seed=seed, device="cpu", evaluation=evaluation
    )


def _mask(*idx, n=2):
    m = np.zeros(n, dtype=bool)
    m[list(idx)] = True
    return m


def _spy_batches(monkeypatch):
    """Record the row count of every evaluator call of the sampler."""
    batches = []
    orig = port_sampler.sample_program_with_deviation

    def spy(tables, f_params, generator, uniforms=None):
        batches.append(f_params.shape[0])
        return orig(tables, f_params, generator, uniforms)

    monkeypatch.setattr(port_sampler, "sample_program_with_deviation", spy)
    return batches


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("mask", [np.zeros(3, bool), np.zeros((2, 1), bool)])
def test_mask_of_wrong_shape_raises(mask):
    with pytest.raises(ValueError, match="postselection_mask"):
        _sampler().sample(10, postselection_mask=mask)


def test_negative_shots_raises():
    with pytest.raises(ValueError, match="shots"):
        _sampler().sample(-1, postselection_mask=_mask(0))


def test_invalid_batch_size_raises():
    with pytest.raises(ValueError, match="batch_size"):
        _sampler().sample(10, batch_size=0, postselection_mask=_mask(0))


def test_device_none_needs_a_card():
    """Without a device the sampler runs on the card, and without a card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_sampler.CompiledDetectorSampler(_exported(MIXED), seed=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cultivation_d3(checks=2).compile_detector_sampler(seed=0)


# --------------------------------------------------------- mask coercion
def test_coerce_mask_none_passthrough():
    assert _sampler()._coerce_postselection_mask(None) is None


def test_direct_detector_mask_matches_tsim_tpu():
    for text in (MIXED, DIRECT_OBS_MIXED, DIRECT_ONLY, FLIPPED):
        np.testing.assert_array_equal(
            _sampler(text)._direct_detector_mask, _reference(text)._direct_detector_mask
        )


def test_coerce_mask_collapses_without_direct_overlap():
    s = _sampler()
    non_direct = _mask(*np.flatnonzero(~s._direct_detector_mask))
    assert s._coerce_postselection_mask(non_direct) is None


def test_coerce_mask_collapses_on_fully_direct_program():
    assert _sampler(DIRECT_ONLY)._coerce_postselection_mask(_mask(0)) is None


def test_coerce_mask_keeps_prefilterable_mask():
    s = _sampler()
    direct = np.flatnonzero(s._direct_detector_mask)
    kept = s._coerce_postselection_mask(_mask(direct[0]))
    assert kept is not None and kept.dtype == np.bool_ and kept[direct[0]]


def test_coerce_mask_accepts_int_array():
    s = _sampler()
    as_int = s._direct_detector_mask.astype(np.int64)
    kept = s._coerce_postselection_mask(as_int)
    assert kept is not None and kept.dtype == np.bool_


# --------------------------------------------------------- defaults/shape
@pytest.mark.parametrize("mask", [None, _mask(), _mask(1)], ids=["none", "all_false", "non_direct"])
def test_masks_without_prefilter_match_default(mask):
    a = _sampler(seed=3).sample(500, batch_size=500)
    b = _sampler(seed=3).sample(500, batch_size=500, postselection_mask=mask)
    np.testing.assert_array_equal(a, b)


def test_return_shape_preserved():
    assert _sampler().sample(321, batch_size=128, postselection_mask=_mask(0)).shape == (321, 2)


def test_zero_shots():
    assert _sampler().sample(0, postselection_mask=_mask(0)).shape == (0, 2)


# ---------------------------------------------------- discarded-row rules
def test_discarded_rows_component_cols_false():
    det, obs = _sampler(seed=5).sample(
        4000, batch_size=512, postselection_mask=_mask(0), separate_observables=True
    )
    discarded = det[:, 0]
    assert not det[discarded, 1].any()
    assert not obs[discarded, 0].any()
    assert 0.05 < det[~discarded, 1].mean() < 0.5
    assert abs(discarded.mean() - 0.3) < 0.04


def test_direct_cols_always_populated():
    det = _sampler(seed=6).sample(4000, batch_size=512, postselection_mask=_mask(0))
    assert abs(det[:, 0].mean() - 0.3) < 0.04


def test_evaluator_skipped_for_direct_discards(monkeypatch):
    batches = _spy_batches(monkeypatch)
    det = _sampler(seed=7).sample(2000, batch_size=500, postselection_mask=_mask(0))
    survivors = int((~det[:, 0]).sum())
    # Only survivors are evaluated, in batches of batch_size and one shorter last batch.
    assert sum(batches) == survivors < 2000
    assert all(b == 500 for b in batches[:-1]) and 0 < batches[-1] <= 500


def test_all_discard_skips_evaluator_entirely(monkeypatch):
    batches = _spy_batches(monkeypatch)
    det = _sampler(ALWAYS_DISCARD, seed=23).sample(40, batch_size=8, postselection_mask=_mask(0))
    assert det[:, 0].all() and not det[:, 1].any()
    assert batches == []


def test_direct_cols_match_direct_compute(monkeypatch):
    """The direct detector column equals the direct outputs of the drawn
    noise rows, for every row (discarded or not)."""
    s = _sampler(seed=22)
    drawn = []
    orig = s._device_channels.sample

    def capture(generator, n):
        batch = orig(generator, n)
        drawn.append(batch.clone())
        return batch

    monkeypatch.setattr(s._device_channels, "sample", capture)
    det = s.sample(64, batch_size=16, postselection_mask=_mask(0))
    expect = s._tables.direct_outputs(torch.cat(drawn)).numpy()[:, :2].astype(bool)
    direct = s._direct_detector_mask
    np.testing.assert_array_equal(det & direct, expect & direct)


def test_discarded_and_surviving_rows():
    det = _sampler(seed=21).sample(600, batch_size=64, postselection_mask=_mask(0))
    discarded = det[:, 0]
    assert discarded.any() and (~discarded).any()
    assert not det[discarded, 1].any()


def test_discarded_rows_zero_direct_observable():
    s = _sampler(DIRECT_OBS_MIXED, seed=31)
    det, obs = s.sample(600, batch_size=64, postselection_mask=_mask(0), separate_observables=True)
    discarded = det[:, 0]
    assert discarded.any() and (~discarded).any()
    assert not obs[discarded, 0].any()
    assert 0.02 < obs[~discarded, 0].mean() < 0.25


# ------------------------------------------------------- fully direct path
@pytest.mark.parametrize("mask", [None, _mask(0, 1)])
def test_fully_direct_program_raises(mask):
    """The host route of an exported fully-direct program: tsim_tpu's bits
    at the same seed with or without a mask, and a mask of the wrong shape
    raises."""
    port = _sampler(DIRECT_ONLY, seed=21)
    ref = tsim_tpu.Circuit(DIRECT_ONLY).compile_detector_sampler(seed=21)
    assert port.direct_route == "host_channels"
    for kw in ({}, {"use_detector_reference_sample": True, "append_observables": True}):
        got = port.sample(500, postselection_mask=mask, **kw)
        np.testing.assert_array_equal(got, ref.sample(500, postselection_mask=mask, **kw))
        assert got.shape[0] == 500  # nothing is discarded
    with pytest.raises(ValueError, match="postselection_mask"):
        port.sample(10, postselection_mask=np.ones(3, bool))


# ------------------------------------------------------ reference XOR rules
def test_detector_reference_with_postselection():
    det = _sampler(seed=11).sample(
        2000, batch_size=512, postselection_mask=_mask(0), use_detector_reference_sample=True
    )
    assert abs(det[:, 0].mean() - 0.3) < 0.05


def test_observable_reference_only_on_survivors():
    det, obs = _sampler(seed=12).sample(
        3000, batch_size=512, postselection_mask=_mask(0),
        separate_observables=True, use_observable_reference_sample=True,
    )
    assert not obs[det[:, 0], 0].any()


def test_reference_flags_off_do_not_change_the_stream():
    a = _sampler(seed=13).sample(400, batch_size=400, postselection_mask=_mask(0))
    s = _sampler(seed=13)
    s._reference_sample()  # a cached reference draws from a generator of its own
    b = s.sample(400, batch_size=400, postselection_mask=_mask(0))
    np.testing.assert_array_equal(a, b)


def test_detector_reference_xor_applies_before_discard_check(monkeypatch):
    """Detector 0 fires without noise: with the reference off almost every
    shot is discarded; the reference XOR cancels it before the check."""
    batches = _spy_batches(monkeypatch)
    _sampler(FLIPPED, seed=26).sample(64, batch_size=16, postselection_mask=_mask(0))
    n_off = sum(batches)
    del batches[:]
    _sampler(FLIPPED, seed=26).sample(
        64, batch_size=16, postselection_mask=_mask(0), use_detector_reference_sample=True
    )
    assert sum(batches[1:]) > n_off  # batches[0] is the reference row's evaluation


def test_observable_reference_xor_only_on_survivors_deterministic():
    det, obs = _sampler(DETERMINISTIC_OBS, seed=27).sample(
        400, batch_size=64, postselection_mask=_mask(0),
        separate_observables=True, use_observable_reference_sample=True,
    )
    discarded = det[:, 0]
    assert discarded.any() and (~discarded).any()
    assert not obs[:, 1].any()


def test_all_false_mask_detector_reference_matches_unmasked():
    a = _sampler(seed=29).sample(80, batch_size=16, postselection_mask=_mask(),
                                 use_detector_reference_sample=True)
    b = _sampler(seed=29).sample(80, batch_size=16, use_detector_reference_sample=True)
    np.testing.assert_array_equal(a, b)


def test_detector_reference_survivors_and_discarded():
    det = _sampler(FLIPPED, seed=30).sample(
        400, batch_size=64, postselection_mask=_mask(0), use_detector_reference_sample=True
    )
    assert abs(det[:, 0].mean() - 0.3) < 0.08
    assert not det[det[:, 0], 1].any()


# ------------------------------------------------------------ output layout
@pytest.mark.parametrize(
    "kw, shape",
    [
        ({"append_observables": True}, (200, 3)),
        ({"prepend_observables": True}, (200, 3)),
        ({"bit_packed": True}, (200, 1)),
    ],
)
def test_output_layouts(kw, shape):
    out = _sampler(seed=14).sample(200, batch_size=200, postselection_mask=_mask(0), **kw)
    assert out.shape == shape


def test_output_layout_separate_and_consistent():
    def run(**kw):
        return _sampler(seed=14).sample(200, batch_size=64, postselection_mask=_mask(0),
                                        use_observable_reference_sample=True, **kw)

    full = run(append_observables=True)
    det, obs = run(separate_observables=True)
    assert det.shape == (200, 2) and obs.shape == (200, 1)
    np.testing.assert_array_equal(np.hstack([det, obs]), full)
    np.testing.assert_array_equal(run(prepend_observables=True), np.hstack([obs, det]))
    np.testing.assert_array_equal(run(bit_packed=True), np.packbits(det, axis=1, bitorder="little"))


# ----------------------------------------------------- against tsim_tpu
def _tsim_tpu_draws(sampler, key, batch, compute_reference):
    """The draw uniforms of tsim_tpu's single survivor dispatch: the key
    split by the reference sample (when asked), then by the dispatch, then
    one split per rung (``sampler.py:75``; bernoulli is uniform < p)."""
    if compute_reference:
        key, _ = jax.random.split(key)
    key, sub = jax.random.split(key)
    draws = []
    for comp in sampler._program.components:
        for _ in comp.compiled_scalar_graphs[1:]:
            sub, dk = jax.random.split(sub)
            draws.append(torch.from_numpy(np.array(jax.random.uniform(dk, (batch,), jnp.float32))))
    return draws


@pytest.mark.parametrize(
    "text, refs",
    [(MIXED, False), (FLIPPED, True), (DIRECT_OBS_MIXED, True), (DETERMINISTIC_OBS, True)],
    ids=["mixed", "flipped_refs", "direct_obs_refs", "deterministic_obs_refs"],
)
def test_postselected_run_matches_tsim_tpu(monkeypatch, text, refs):
    """Fixed noise rows and tsim_tpu's draw uniforms: direct columns,
    discarded rows and the survivors' bits all equal tsim_tpu's."""
    shots = 300
    jax_sampler = tsim_tpu.Circuit(text).compile_detector_sampler(seed=4)
    num_f = jax_sampler._channel_sampler.signature_matrix.shape[1]
    f = np.random.default_rng(17).integers(0, 2, size=(shots, num_f)).astype(np.uint8)
    monkeypatch.setattr(jax_sampler._channel_sampler, "sample", lambda n: f[:n].copy())
    kw = dict(
        batch_size=shots, postselection_mask=_mask(0), append_observables=True,
        use_detector_reference_sample=refs, use_observable_reference_sample=refs,
    )
    port = _sampler(text, seed=4, evaluation="exact")
    if refs:
        port._reference = jax_sampler._compute_reference_sample().copy()
    draws = _tsim_tpu_draws(jax_sampler, jax_sampler._key, shots, refs)
    want = jax_sampler.sample(shots, **kw)

    monkeypatch.setattr(port._device_channels, "sample", lambda gen, n: torch.from_numpy(f[:n].copy()))
    orig = port_sampler.sample_program_with_deviation
    evaluated = []

    def injected(tables, f_params, generator):
        evaluated.append(f_params.shape[0])
        return orig(tables, f_params, None, [d[: f_params.shape[0]] for d in draws])

    monkeypatch.setattr(port_sampler, "sample_program_with_deviation", injected)
    got = port.sample(shots, **kw)
    assert len(evaluated) == 1 and 0 < evaluated[0] < shots  # one survivor batch; some discards
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "text",
    [MIXED, FLIPPED, DIRECT_OBS_MIXED, DETERMINISTIC_OBS],
    ids=["mixed", "flipped", "direct_obs", "deterministic_obs"],
)
def test_reference_sample_matches_tsim_tpu_where_deterministic(text):
    s = _sampler(text, seed=1)
    deterministic = _deterministic_outputs(s)
    want = _reference(text)._compute_reference_sample()
    got = s._reference_sample()
    assert deterministic[: s._num_detectors][s._direct_detector_mask].all()
    np.testing.assert_array_equal(got[deterministic], want[deterministic])


def _deterministic_outputs(sampler, rows=256):
    """Outputs that take one value on every one of ``rows`` draws of the
    all-zero noise row."""
    f = torch.zeros((rows, sampler._device_channels.num_f), dtype=torch.uint8)
    out, _ = port_sampler.sample_program_with_deviation(sampler._tables, f, sampler._generator)
    out = out.numpy()
    return (out == out[:1]).all(axis=0)


# ------------------------------------------------- 2-check cultivation
@pytest.fixture(scope="module")
def cultivation():
    return cultivation_d3(p=0.001, checks=2)


def test_cultivation_reference_matches_exported_tsim_tpu_reference(cultivation):
    exported = cultivation.load()
    s = cultivation.compile_detector_sampler(seed=0, device="cpu")
    deterministic = _deterministic_outputs(s)
    want = exported.replay["reference_sample"].astype(bool)
    assert deterministic[: s._num_detectors].all()  # every detector is deterministic
    np.testing.assert_array_equal(s._reference_sample()[deterministic], want[deterministic])


def test_cultivation_postselected_rows(cultivation, monkeypatch):
    """Noise rows with every f-bit at rate 1/2 make the direct detectors
    fire often: discarded rows keep only their direct detector columns and
    never reach the evaluator; survivors are evaluated in full."""
    s = cultivation.compile_detector_sampler(seed=2, device="cpu")
    nd, num_f = s._num_detectors, s._device_channels.num_f
    rng = np.random.default_rng(5)
    monkeypatch.setattr(
        s._device_channels, "sample",
        lambda gen, n: torch.from_numpy(rng.integers(0, 2, size=(n, num_f)).astype(np.uint8)),
    )
    batches = _spy_batches(monkeypatch)
    mask = np.ones(nd, bool)
    det, obs = s.sample(
        192, batch_size=64, postselection_mask=mask, separate_observables=True,
        use_detector_reference_sample=True, use_observable_reference_sample=True,
    )
    direct = s._direct_detector_mask
    discarded = (det & direct).any(axis=1)  # the reference row is 0 on every detector
    assert discarded.any() and (~discarded).any()
    assert not det[discarded][:, ~direct].any() and not obs[discarded].any()
    assert sum(batches[1:]) == int((~discarded).sum())
    assert s.last_norm_deviation <= port_sampler.norm_deviation_tolerance("f32")
