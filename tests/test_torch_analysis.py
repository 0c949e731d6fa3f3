"""The port's analysis toolkit (cha1_mcmc_tpu_torch/analysis), converters
(reduce/converters.py) and native SPCAT tokenizer (catalogs/native.py)
against the JAX package, on inputs made from a NumPy seed.

Tolerances: the NumPy modules' outputs equal the JAX package's (arrays,
NaNs in place, dtypes, files); grid_chi2 and best_fit_inspection in f64
to 1e-12 relative, with the same argmin and thetas; run_adaptive_metropolis
under the JAX package's per-round randomness: f64 chains bitwise, equal
acceptance and adapted widths, lnps rtol 1e-12; the native tokenizer's
fields bitwise equal to the Python tokenizer's and to the JAX package's
native tokenizer. The twins of tests/test_analysis.py and
tests/test_convergence.py keep their tolerances."""

import contextlib
import dataclasses
import importlib
import io
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import (STDS_4, TRUTH_4, jax_model, jax_reduce, port_model,
                                problem, spec_and_prior, walker_ball)

torch.set_num_threads(1)


def _synthetic_obs(seed=0, n_lines=6, noise=1e-3, amp=5e-3, dV=0.5):
    """Observed spectrum with weak Gaussians at known rest frequencies, plus
    a matching noiseless fine simulation (tests/test_analysis.py's helper)."""
    rng = np.random.default_rng(seed)
    freq_obs = np.arange(18000.0, 19000.0, 0.03)
    ckm = 299792.458
    line_freqs = np.sort(rng.uniform(18100, 18900, n_lines))
    amps = amp * rng.uniform(0.5, 1.0, n_lines)
    int_obs = rng.normal(0, noise, freq_obs.size)
    for f, a in zip(line_freqs, amps):
        sigma = dV * f / ckm / 2.35482
        int_obs += a * np.exp(-0.5 * ((freq_obs - f) / sigma) ** 2)
    freq_sim = np.arange(18000.0, 19000.0, 0.01)
    int_sim = np.zeros_like(freq_sim)
    for f, a in zip(line_freqs, amps):
        sigma = dV * f / ckm / 2.35482
        int_sim += a * np.exp(-0.5 * ((freq_sim - f) / sigma) ** 2)
    return freq_obs, int_obs, freq_sim, int_sim, line_freqs, amps


# -- the copied NumPy modules: one case per public function ---------------------

def _module(pkg, name):
    path = "reduce.converters" if name == "converters" else f"analysis.{name}"
    return importlib.import_module(f"{pkg}.{path}")


def _read(path):
    with open(path) as fh:
        return fh.read()


def _obs():
    return _synthetic_obs(noise=2e-4, amp=5e-3)


def _gauss_fit(m, d):
    rng = np.random.default_rng(0)
    freq = np.arange(18000.0, 18010.0, 0.01)
    y = (m.gauss_func(freq, 0.05, 18003.0, 0.8) + m.gauss_func(freq, 0.02, 18007.0, 0.6)
         + rng.normal(0, 1e-4, freq.size))
    return (m.gauss_fit(freq, y, [[0.05, 18003.0, 0.8], [0.02, 18007.0, 0.6]]),
            m.gauss_fit(freq, y, [[0.04, 18003.1, 0.7]], sigma=[1e-4]))


def _make_gauss_params(m, d):
    path = os.path.join(d, "lines.txt")
    with open(path, "w") as fh:
        fh.write("18638.6 0.05\n\n21301.25 0.03\n")
    return m.make_gauss_params(path, 4.1, 0.78)


def _obs_chunk(m, d):
    fo, io_, fs, is_, lf, _ = _obs()
    sel, sim = slice(100, 400), slice(300, 1200)
    return (m.ObsChunk(fo[sel], io_[sel], fo[250], 0.004, 3, freq_sim=fs[sim],
                       int_sim=is_[sim]),
            m.ObsChunk(fo[:1], io_[:1], fo[0], 0.004, 1))


def _velocity_stack(m, d, **kw):
    fo, io_, fs, is_, lf, _ = _obs()
    return m.velocity_stack(fo, io_, fs, is_, 0.5, 0.01, **kw)


def _velocity_stack_sum(m, d):
    fo, io_, fs, is_, lf, _ = _obs()
    return m.velocity_stack(fo, io_, None, None, 0.5, 0.01, use_sum=True, freq_sum=fs,
                            int_sum=is_, cat_frequency=np.sort(np.r_[lf, lf + 3.0]),
                            vlsr=0.3)


def _matched_filter(m, d):
    fo, io_, fs, is_, lf, _ = _obs()
    st = m.velocity_stack(fo, io_, fs, is_, 0.5, 0.01, mf=True)
    return m.matched_filter(st.velocity, st.snr, st.sim_snr)


def _find_vel_peaks(m, d):
    fo, io_, fs, is_, lf, _ = _obs()
    st = m.velocity_stack(fo, io_, fs, is_, 0.5, 0.01)
    return m.find_vel_peaks(st.velocity, st.snr, fwhm=0.5, sigma=4)


def _render(m, d, **kw):
    _, _, _, _, lf, amps = _obs()
    return m.render_gaussian_profile(lf, amps, 0.5, 18000.0, 19000.0, 0.01, **kw)


def _tbg(m, d):
    f = np.linspace(18000.0, 26000.0, 400)
    return [m.calc_tbg(5.2, "constant", [], f),
            m.calc_tbg([3.0, 4.0], "constant", [(18000, 20000), (22000, 30000)], f),
            m.calc_tbg([[1e-4, 2.0]], "poly", [], f),
            m.calc_tbg([[1e-4, 2.0], [3.0]], "poly", [(18000, 20000), (22000, 24000)], f),
            m.calc_tbg([2.0, -0.3, 1.0], "power", [], f),
            m.calc_tbg([[2.0, -0.3, 1.0], [1.0, 0.1, 0.0]], "power",
                       [(18000, 20000), (22000, 24000)], f),
            m.calc_tbg([], "sgrb2", [], f),
            m.calc_tbg([20.0, 1.5, 0.1, 230.0, 10.0, 8.0], "greybody", [], f)]


def _write_spectrum(m, d):
    fo, io_, *_ = _obs()
    path = os.path.join(d, "spec.txt")
    m.write_spectrum(fo[:50], io_[:50], path)
    return _read(path)


def _ulim(m, d):
    fo, io_, fs, is_, lf, _ = _obs()
    return (m.get_obs_rms(fo, io_, 18100.0, 18500.0),
            m.get_sim_peak(fs, is_, 18100.0, 18500.0),
            m.get_sim_peak(fs, -is_, 18100.0, 18500.0, absorption=True),
            m.get_sim_peak(fs, is_, 17000.0, 17500.0),
            m.upper_limit_column(3.4e12, fs, is_, fo, io_, 18100.0, 18900.0),
            m.upper_limit_column(3.4e12, fs, is_, fo, io_, 18100.0, 18900.0, level=1e-3))


def _lis(m, d):
    rng = np.random.default_rng(2)
    path = os.path.join(d, "spec.lis")
    rows = rng.uniform(1.0, 2.0, (30, 5))
    rows[:, 0] = np.arange(18000.0, 18000.3, 0.01)
    np.savetxt(path, rows, header="a\nb\nc", comments="")
    return m.lis_to_array(path)


def _ascii(m, d):
    path = os.path.join(d, "spec.txt")
    rows = np.random.default_rng(3).uniform(0.0, 1.0, (20, 3))
    np.savetxt(path, rows, header="freq int extra", comments="")
    return m.ascii_to_array(path, int_col=2, skip_header=1)


def _spec(m, d):
    path = os.path.join(d, "line.spec")
    rows = np.c_[np.linspace(-5.0, 5.0, 41), np.random.default_rng(4).normal(0, 1, 41)]
    np.savetxt(path, rows)
    return m.spec_to_array(path, 18638.6)


def _read_obs(m, d):
    rng = np.random.default_rng(5)
    freqs = np.r_[18.6385, 18.6385, np.arange(18.6386, 18.6406, 0.0001)]
    ints = rng.normal(0.0, 0.01, freqs.size)
    ints[7] = 0.2
    ispec = os.path.join(d, "obs.ispec")
    with open(ispec, "w") as fh:
        fh.write("#title: Spectral profile\n#region: box\n#xLabel: frequency [GHz]\n"
                 "#yLabel: [Jy/beam]\n")
        fh.writelines(f"{f:.7f} {i:.6e}\n" for f, i in zip(freqs[::-1], ints[::-1]))
    plain = os.path.join(d, "obs.txt")
    with open(plain, "w") as fh:
        fh.writelines(f"{f * 1000:.4f} {i:.6e}\n" for f, i in zip(freqs, ints))
        fh.write("\n")
    return m.read_obs(ispec), m.read_obs(plain), m.read_obs(plain, rms=0.01)


CASES = {
    "conversions.jy_to_k": lambda m, d: m.jy_to_k(
        np.random.default_rng(0).uniform(0.1, 2.0, 50), np.linspace(18000, 25000, 50),
        5.0, 4.0),
    "conversions.k_to_jy": lambda m, d: m.k_to_jy(
        np.random.default_rng(0).uniform(0.1, 2.0, 50), np.linspace(18000, 25000, 50),
        5.0, 4.0),
    "conversions.planck_k_to_jy": lambda m, d: m.planck_k_to_jy(
        np.r_[0.0, 1e-4, np.random.default_rng(1).uniform(0.1, 20.0, 30), 0.0],
        np.linspace(18000, 250000, 33), (10.0, 6.0)),
    "fitting.gauss_func": lambda m, d: m.gauss_func(np.linspace(18000, 18010, 101),
                                                    0.05, 18005.0, 0.8),
    "fitting.gauss_fit": _gauss_fit,
    "fitting.make_gauss_params": _make_gauss_params,
    "stacking.get_rms": lambda m, d: m.get_rms(_obs()[1]),
    "stacking.find_nearest": lambda m, d: [m.find_nearest(_obs()[0], v)
                                           for v in (17000.0, 18500.014, 18500.016, 20000.0)],
    "stacking.find_sim_peaks": lambda m, d: m.find_sim_peaks(_obs()[2], _obs()[3], 0.5, 0.01),
    "stacking.ObsChunk": _obs_chunk,
    "stacking.velocity_stack": _velocity_stack,
    "stacking.velocity_stack-flag-blank": lambda m, d: _velocity_stack(
        m, d, drops=(1,), flag_lines=True, blank_lines=True, blank_keep_range=(-2, 2)),
    "stacking.velocity_stack-blank": lambda m, d: _velocity_stack(m, d, blank_lines=True),
    "stacking.velocity_stack-use-sum": _velocity_stack_sum,
    "stacking.matched_filter": _matched_filter,
    "stacking.find_vel_peaks": _find_vel_peaks,
    "stacking.cut_spectra": lambda m, d: m.cut_spectra(_obs()[0], _obs()[1], _obs()[4],
                                                       dV=0.5, n_fwhm=10),
    "peaks.find_peaks": lambda m, d: m.find_peaks(_obs()[0], _obs()[1], fwhm=0.5, sigma=5),
    "peaks.find_obs_peaks": lambda m, d: m.find_obs_peaks(
        *_synthetic_obs(amp=2e-2)[:2], sigma=5, fwhm=0.5),
    "peaks.find_obs_brights": lambda m, d: m.find_obs_brights(
        *_synthetic_obs(amp=2e-2)[:2], end_chan=20000),
    "renderer.render_gaussian_profile": _render,
    "renderer.render_gaussian_profile-cavity": lambda m, d: _render(m, d, cavity_split=0.3),
    "renderer.render_gaussian_profile-two-fwhm": lambda m, d: _render(m, d,
                                                                      two_fwhm_only=True),
    "renderer.render_gaussian_profile-match-obs": lambda m, d: _render(
        m, d, match_obs=_obs()[0], rms=2e-3),
    "tbg.calc_tbg": _tbg,
    "obs_tools.subtract_baseline": lambda m, d: (
        m.subtract_baseline(_obs()[0], _obs()[1], [1e-3, -1e-8]),
        m.subtract_baseline(_obs()[0], _obs()[1], 0.5)),
    "obs_tools.write_spectrum": _write_spectrum,
    "obs_tools.get_subtraction": lambda m, d: (
        m.get_subtraction(*_obs()[:4], 18000, 19000),
        m.get_subtraction(_obs()[0], _obs()[1], _obs()[2][1000:2000], _obs()[3][1000:2000],
                          18000, 19000)),
    "obs_tools.residual_spectrum": lambda m, d: m.residual_spectrum(*_obs()[:4]),
    "obs_tools.find_limits": lambda m, d: m.find_limits(np.concatenate(
        [np.arange(18630.0, 18650.0, 0.01), np.arange(21290.0, 21310.0, 0.01),
         np.arange(23950.0, 23970.0, 0.01)])),
    "ulim.get_obs_rms-get_sim_peak-upper_limit_column": _ulim,
    "ulim.find_best_ulim_lines": lambda m, d: m.find_best_ulim_lines(
        _obs()[2], _obs()[3], _obs()[0], _obs()[1], 0.5, 0.01, n=3),
    "converters.lis_to_array": _lis,
    "converters.ascii_to_array": _ascii,
    "converters.velocity_to_frequency": lambda m, d: m.velocity_to_frequency(
        np.linspace(-10.0, 10.0, 21), 18638.6),
    "converters.spec_to_array": _spec,
    "converters.read_obs": _read_obs,
}


def _assert_same(a, b, where="out"):
    """Equal values of the same kind: arrays (dtype, NaNs in place),
    sequences, dataclasses and objects by their attributes, scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        _assert_same(vars(a), vars(b), f"{where}:{type(a).__name__}")
    elif isinstance(a, float) or isinstance(b, float):
        assert type(a) is type(b), (where, type(a), type(b))
        assert a == b or (np.isnan(a) and np.isnan(b)), (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_copied_function_equals_jax(case, tmp_path):
    """Each public function of the copied NumPy modules returns what the
    JAX package's returns on the same synthetic spectra."""
    name = case.split(".")[0]
    outs = []
    for pkg in ("cha1_mcmc_tpu", "cha1_mcmc_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        outs.append(CASES[case](_module(pkg, name), str(d)))
    _assert_same(*outs)


# -- twins of tests/test_analysis.py --------------------------------------------

def test_obs_scans_find_injected_lines():
    """find_obs_peaks recovers the injected lines chunk by chunk;
    find_obs_brights flags their channels (reference :7363/:7433)."""
    from cha1_mcmc_tpu_torch.analysis.peaks import find_obs_peaks, find_obs_brights

    freq_obs, int_obs, _, _, line_freqs, _ = _synthetic_obs(amp=2e-2)
    freqs, ints, rms = find_obs_peaks(freq_obs, int_obs, sigma=5, fwhm=0.5)
    assert len(freqs) == len(rms)
    for lf in line_freqs:
        assert np.min(np.abs(np.asarray(freqs) - lf)) < 0.06, lf
    bf, bi = find_obs_brights(freq_obs, int_obs)
    assert len(bf) >= len(line_freqs)
    assert np.all(np.asarray(bi) > 0)


def test_residual_spectrum_recovers_noise():
    """obs = model + noise: the residual against the true model is the
    noise (plot_residuals' compute core)."""
    from cha1_mcmc_tpu_torch.analysis.obs_tools import residual_spectrum

    freq_obs, int_obs, freq_sim, int_sim, *_ = _synthetic_obs(noise=1e-3)
    f, resid = residual_spectrum(freq_obs, int_obs, freq_sim, int_sim)
    np.testing.assert_array_equal(f, freq_obs)
    assert abs(resid.std() - 1e-3) < 2e-4
    assert resid.std() < int_obs.std()


def test_gauss_fit_recovers_parameters():
    from cha1_mcmc_tpu_torch.analysis import gauss_fit, gauss_func

    rng = np.random.default_rng(0)
    freq = np.arange(18000.0, 18010.0, 0.01)
    truth = [(0.05, 18005.0, 0.8)]
    y = gauss_func(freq, *truth[0]) + rng.normal(0, 1e-4, freq.size)
    [res] = gauss_fit(freq, y, [list(truth[0])])
    dT, dT_err, v, v_err, dV, dV_err = res
    assert abs(dT - 0.05) < 5e-4
    assert abs(v - 18005.0) < 0.01
    assert abs(dV - 0.8) < 0.02


def test_jy_k_roundtrip():
    from cha1_mcmc_tpu_torch.analysis import jy_to_k, k_to_jy

    rng = np.random.default_rng(0)
    jy = rng.uniform(0.1, 2.0, 100)
    freq = np.linspace(18000, 25000, 100)
    k = jy_to_k(jy, freq, 5.0, 4.0)
    np.testing.assert_allclose(k_to_jy(k, freq, 5.0, 4.0), jy, rtol=1e-12)


def test_find_peaks_synthetic():
    from cha1_mcmc_tpu_torch.analysis import find_peaks

    freq_obs, int_obs, _, _, line_freqs, _ = _synthetic_obs(noise=2e-4, amp=5e-3)
    idx, rms = find_peaks(freq_obs, int_obs, fwhm=0.5, sigma=5)
    found = np.sort(freq_obs[idx])
    assert len(found) == len(line_freqs)
    np.testing.assert_allclose(found, line_freqs, atol=0.05)


def test_cut_spectra_and_find_vel_peaks():
    from cha1_mcmc_tpu_torch.analysis import cut_spectra, find_vel_peaks, velocity_stack

    freq_obs, int_obs, freq_sim, int_sim, line_freqs, _ = _synthetic_obs(
        noise=2e-4, amp=5e-3)
    fc, ic = cut_spectra(freq_obs, int_obs, line_freqs, dV=0.5, n_fwhm=10)
    assert fc.size > 0
    ckm = 2.998e5
    dists = np.min(np.abs(fc[:, None] - line_freqs[None, :]) /
                   (line_freqs[None, :] / ckm), axis=1)
    assert dists.max() < 10 * 0.5 + 0.1
    stack = velocity_stack(freq_obs, int_obs, freq_sim, int_sim, 0.5, 0.01)
    idx, rms = find_vel_peaks(stack.velocity, stack.snr, fwhm=0.5, sigma=4)
    assert len(idx) >= 1
    assert np.any(np.abs(stack.velocity[idx]) < 0.5)


# -- grid chi^2 and best-fit inspection on the synthetic flagship ---------------

@pytest.fixture(scope="module")
def flagship(problem):
    """(JAX f64 model, port f64 model, port f32 model, JAX spec, port
    spec, datagrid) on identical constants."""
    from cha1_mcmc_tpu.inference import ParamSpec
    from cha1_mcmc_tpu_torch.inference import ParamSpec as PortSpec

    cat, grid = jax_reduce(problem)
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
    ss = spec_and_prior(4)[0]
    return dict(jm=jm, pm=port_model(jm, torch.float64), pm32=port_model(jm, torch.float32),
                jspec=ParamSpec(ncomp=1, fixed_source_size=ss),
                pspec=PortSpec(ncomp=1, fixed_source_size=ss), grid=grid)


GRID_625 = {"Ncol": np.linspace(2.0e12, 4.5e12, 5), "Tex": np.linspace(6.0, 9.0, 5),
            "vlsr": np.linspace(4.05, 4.17, 5), "dV": np.linspace(0.65, 0.9, 5)}


def test_grid_chi2_matches_jax(flagship):
    """625 grid points in f64: thetas equal, chi^2 to 1e-12 relative, the
    same argmin; the port's batches (64) cover a ragged last batch."""
    from cha1_mcmc_tpu.analysis.crosscheck import grid_chi2 as jax_grid
    from cha1_mcmc_tpu_torch.analysis import grid_chi2

    g = flagship["grid"]
    with jax.enable_x64():
        tj, cj, bj = jax_grid(flagship["jm"], flagship["jspec"], g.ints, g.yerrs, GRID_625)
    tp, cp, bp = grid_chi2(flagship["pm"], flagship["pspec"], g.ints, g.yerrs, GRID_625,
                           batch=64)
    assert tp.shape == (625, 4) and cp.shape == (625,)
    np.testing.assert_array_equal(tp, tj)
    np.testing.assert_allclose(cp, cj, rtol=1e-12)
    assert np.argmin(cp) == np.argmin(cj)
    np.testing.assert_array_equal(bp, bj)


def test_grid_chi2_minimum_near_best_fit(flagship):
    """Twin of tests/test_workbench.py::test_grid_chi2_minimum_near_best_fit
    on the synthetic flagship (injected Ncol 3.2e12, vlsr 4.11, dV 0.78),
    float32 as the fit runs."""
    from cha1_mcmc_tpu_torch.analysis.crosscheck import grid_chi2

    g = flagship["grid"]
    grids = {
        "Ncol": np.linspace(1e12, 6e12, 21),
        "Tex": np.linspace(5.0, 10.0, 11),
        "vlsr": np.linspace(4.0, 4.2, 9),
        "dV": np.linspace(0.6, 1.0, 9),
    }
    thetas, chi2, best = grid_chi2(flagship["pm32"], flagship["pspec"], g.ints, g.yerrs,
                                   grids, batch=2048)
    assert thetas.shape[0] == 21 * 11 * 9 * 9
    assert 2e12 < best[0] < 5e12
    assert abs(best[2] - 4.11) < 0.05
    assert 0.6 <= best[3] <= 0.9


def test_best_fit_inspection_matches_jax(flagship, tmp_path):
    """Per-line panels in f64 (the models to 1e-12 relative to each
    panel's peak: the two packages' exp differ by an ulp, which 1 - exp(-tau)
    lifts to ~1e-11 of the smallest values in a line's wings; the data
    windows and fine grids equal) and the same text table."""
    from cha1_mcmc_tpu.analysis import inspection as jins
    from cha1_mcmc_tpu_torch.analysis import inspection as pins

    g, theta = flagship["grid"], np.array([3.24e12, 7.53, 4.11, 0.78])
    with jax.enable_x64():
        jp = jins.best_fit_inspection(flagship["jm"], flagship["jspec"], g, theta)
        on_grid = np.asarray(flagship["jm"].forward(*flagship["jspec"].unpack(
            jnp.asarray(theta))))
    pp = pins.best_fit_inspection(flagship["pm"], flagship["pspec"], g, theta)
    assert len(pp) == len(jp) == flagship["pm"].n_lines
    for a, b in zip(pp, jp):
        assert a.line_freq == b.line_freq
        for name in ("obs_freq", "obs_int", "fine_freq"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for name in ("obs_model", "fine_model"):
            ref = getattr(b, name)
            np.testing.assert_allclose(getattr(a, name), ref, rtol=1e-12,
                                       atol=1e-12 * np.abs(ref).max(), err_msg=name)
        assert a.fine_freq.shape == (1000,) and a.fine_model.max() > 0
    jins.export_model_table(str(tmp_path / "jax.txt"), g, on_grid)
    pins.export_model_table(str(tmp_path / "port.txt"), g, on_grid)
    pins.export_model_table(str(tmp_path / "tensor.txt"), g, torch.from_numpy(on_grid))
    assert _read(tmp_path / "port.txt") == _read(tmp_path / "jax.txt")
    assert _read(tmp_path / "tensor.txt") == _read(tmp_path / "jax.txt")
    assert np.loadtxt(tmp_path / "port.txt").shape == (g.freqs.size, 3)


def test_with_grid_matches_build(flagship):
    """SpectralModel.with_grid on the model's own channels gives the model
    itself: the velocity grid `build` computed, bitwise."""
    pm = flagship["pm"]
    copy = pm.with_grid(pm.grid_freq.numpy())
    assert torch.equal(copy.vel_grid, pm.vel_grid)
    assert torch.equal(copy.grid_freq, pm.grid_freq)


# -- the independent adaptive-Metropolis engine ---------------------------------

def _jax_rounds(key, lengths, W, D, dtype):
    """Each round's (zs, lnus) as cha1_mcmc_tpu/analysis/independent.py
    draws them: the key split once per round, then into (k_z, k_u)."""
    out = []
    for n in lengths:
        key, sub = jax.random.split(key)
        k_z, k_u = jax.random.split(sub)
        zs = jax.random.normal(k_z, (n, W, D), dtype)
        lnus = jnp.log(jax.random.uniform(k_u, (n, W), dtype))
        out.append((torch.from_numpy(np.array(zs)), torch.from_numpy(np.array(lnus))))
    return out


def _record_widths(monkeypatch):
    """Record the proposal widths each round of both engines runs with."""
    from cha1_mcmc_tpu.analysis import independent as jind
    from cha1_mcmc_tpu_torch.analysis import independent as pind

    widths = {"jax": [], "port": []}
    make = jind._make_mh_run

    def make_recorded(lnprob_batch):
        run = make(lnprob_batch)

        def recorded(pos, lnp, sigma, key, nsteps):
            widths["jax"].append(np.array(sigma))
            return run(pos, lnp, sigma, key, nsteps)
        return recorded

    mh_round = pind._mh_round

    def round_recorded(lnprob_batch, pos, lnp, sigma, zs, lnus):
        widths["port"].append(sigma.numpy().copy())
        return mh_round(lnprob_batch, pos, lnp, sigma, zs, lnus)

    monkeypatch.setattr(jind, "_make_mh_run", make_recorded)
    monkeypatch.setattr(pind, "_mh_round", round_recorded)
    return widths


def _gaussian_target(mean, icov):
    def lnprob(x):
        d = x - mean
        return -0.5 * d @ icov @ d
    return lnprob


def _flagship_lnprobs(flagship):
    from cha1_mcmc_tpu.inference import build_lnprob, single_component_lnprior
    from cha1_mcmc_tpu_torch import inference as port_inf

    _, means, stds, bounds = spec_and_prior(4)
    g = flagship["grid"]
    with jax.enable_x64():
        jl = build_lnprob(flagship["jm"], flagship["jspec"], g.ints, g.yerrs,
                          single_component_lnprior(flagship["jspec"], bounds, means, stds))
    pl = port_inf.build_lnprob(
        flagship["pm"], flagship["pspec"], g.ints, g.yerrs,
        port_inf.single_component_lnprior(flagship["pspec"], bounds, means, stds,
                                          dtype=torch.float64))
    return jl, pl


@pytest.mark.parametrize("target", ["gaussian", "flagship"])
def test_adaptive_metropolis_matches_jax(target, flagship, monkeypatch):
    """Under the JAX package's per-round randomness, f64: the chains
    bitwise, the acceptance and every round's adapted widths equal, the
    lnps to 1e-12 relative. Gaussian: both engines vmap a scalar lnprob
    (batched=False); flagship: the port's batched lnprob (batched=True)
    against the JAX scalar one."""
    from cha1_mcmc_tpu.analysis import run_adaptive_metropolis as jax_run
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis

    W, rounds, round_len, nsteps = 16, 3, 48, 120
    if target == "gaussian":
        mean, icov = np.array([1.5, -2.0]), np.linalg.inv([[1.0, 0.8], [0.8, 1.0]])
        pos0 = np.random.default_rng(0).standard_normal((W, 2)) * 0.3
        sigma0, batched = np.array([0.1, 0.1]), False
        with jax.enable_x64():
            jl = _gaussian_target(jnp.asarray(mean), jnp.asarray(icov))
        pl = _gaussian_target(torch.from_numpy(mean), torch.from_numpy(icov))
    else:
        jl, pl = _flagship_lnprobs(flagship)
        pos0 = walker_ball(TRUTH_4, W, 11)
        sigma0, batched = STDS_4 / 10, True
    widths = _record_widths(monkeypatch)
    key = jax.random.PRNGKey(6)
    with jax.enable_x64():
        cj, lj, aj = jax_run(jl, jnp.asarray(pos0, jnp.float64), key, nsteps=nsteps,
                             init_sigma=sigma0, warmup_rounds=rounds, round_len=round_len)
        rnd = _jax_rounds(key, [round_len] * rounds + [nsteps], W, pos0.shape[1],
                          jnp.float64)
        cj, lj = np.array(cj), np.array(lj)
    cp, lp, ap = run_adaptive_metropolis(
        pl, torch.from_numpy(pos0), nsteps=nsteps, init_sigma=sigma0,
        warmup_rounds=rounds, round_len=round_len, batched=batched, randomness=rnd)
    assert cp.shape == (nsteps, W, pos0.shape[1]) and lp.shape == (nsteps, W)
    np.testing.assert_array_equal(cp.numpy(), cj)
    assert ap == aj and 0.0 < ap < 1.0
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-12)
    assert len(widths["port"]) == len(widths["jax"]) == rounds + 1
    for a, b in zip(widths["port"], widths["jax"]):
        np.testing.assert_array_equal(a, b)


def test_adaptive_metropolis_rejects_bad_randomness():
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis

    pos0 = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="generator or randomness"):
        run_adaptive_metropolis(lambda x: -x @ x, pos0, nsteps=8, init_sigma=[1, 1])
    bad = [(torch.zeros(8, 4, 2), torch.zeros(8, 4))] * 2
    with pytest.raises(ValueError, match="randomness must hold"):
        run_adaptive_metropolis(lambda x: -x @ x, pos0, nsteps=8, init_sigma=[1, 1],
                                warmup_rounds=1, round_len=4, randomness=bad)


def test_adaptive_metropolis_on_gaussian():
    """Twin of tests/test_convergence.py::test_adaptive_metropolis_on_gaussian:
    the engine recovers a known correlated 2-D Gaussian (mean, marginal
    stds, correlation) in float32 from its own generator."""
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis

    mean = torch.tensor([1.5, -2.0])
    icov = torch.from_numpy(np.linalg.inv([[1.0, 0.8], [0.8, 1.0]])).float()
    lnprob = _gaussian_target(mean, icov)
    W = 64
    pos0 = torch.from_numpy(np.random.default_rng(0).standard_normal((W, 2)) * 0.3).float()
    chain, lnps, acc = run_adaptive_metropolis(
        lnprob, pos0, torch.Generator().manual_seed(3), nsteps=3000,
        init_sigma=np.array([0.1, 0.1]))
    assert chain.dtype == torch.float32
    assert 0.1 < acc < 0.6
    s = chain.numpy()[600:].reshape(-1, 2).astype(np.float64)
    np.testing.assert_allclose(s.mean(0), mean.numpy(), atol=0.05)
    np.testing.assert_allclose(s.std(0), 1.0, rtol=0.06)
    np.testing.assert_allclose(np.corrcoef(s.T)[0, 1], 0.8, atol=0.05)


def test_independent_engine_cross_validation_flagship(flagship):
    """Twin of tests/test_convergence.py::
    test_independent_engine_cross_validation_hc5n on the synthetic
    flagship, the posterior gate of the port: its stretch sampler
    (run_ensemble) and its adaptive Metropolis, which share no move
    machinery, agree on the f32 posterior with the JAX test's tolerances
    (means within 0.15 x the stretch std, stds to rtol 0.25)."""
    from cha1_mcmc_tpu_torch import inference as port_inf
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis
    from cha1_mcmc_tpu_torch.sampler import run_ensemble

    _, means, stds, bounds = spec_and_prior(4)
    g, spec = flagship["grid"], flagship["pspec"]
    lnprob = port_inf.build_lnprob(
        flagship["pm32"], spec, g.ints, g.yerrs,
        port_inf.single_component_lnprior(spec, bounds, means, stds))
    W = 64          # the JAX test's 128 halved: the same checks in ~40 s on one core
    rng = np.random.default_rng(11)
    pos0 = torch.from_numpy(means + (stds / 10) * rng.standard_normal((W, 4))).float()
    schain, *_ = run_ensemble(lnprob, pos0, lnprob(pos0), 1200,
                              generator=torch.Generator().manual_seed(5))
    mchain, _, acc = run_adaptive_metropolis(
        lnprob, pos0, torch.Generator().manual_seed(6), nsteps=2400,
        init_sigma=stds / 10, batched=True)
    assert 0.1 < acc < 0.6
    s = schain.numpy()[300:].reshape(-1, 4).astype(np.float64)
    m = mchain.numpy()[600:].reshape(-1, 4).astype(np.float64)
    pooled = s.std(0)
    assert np.all(np.abs(s.mean(0) - m.mean(0)) < 0.15 * pooled)
    np.testing.assert_allclose(s.std(0), m.std(0), rtol=0.25)


# -- the native SPCAT tokenizer ----------------------------------------------------

@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    from tests.port_problems import write_dense_problem, write_hc5n_problem, write_hc9n_problem

    root = tmp_path_factory.mktemp("catalogs")
    with contextlib.redirect_stdout(io.StringIO()):
        return {"hc5n": write_hc5n_problem(str(root / "hc5n"))["cat_path"],
                "hc9n": write_hc9n_problem(str(root / "hc9n"))["cat_path"],
                "dense": write_dense_problem(str(root / "dense"), scale="small")["cat_path"]}


@pytest.mark.parametrize("name", ["hc5n", "hc9n", "dense"])
def test_native_tokenizer_matches_python_and_jax(name, catalogs):
    """The port's native tokenizer (its own copy of the source, built into
    the port's build directory) gives the Python tokenizer's fields and
    the JAX package's native fields bitwise; parse_spcat takes it."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native tokenizer cannot be built here")
    from cha1_mcmc_tpu.catalogs.native import tokenize_native as jax_native
    from cha1_mcmc_tpu_torch.catalogs import native, spcat
    from cha1_mcmc_tpu_torch.utils.cuda_build import BUILD_DIR

    assert native.native_available()
    assert native.build_native().parent == BUILD_DIR
    with open(catalogs[name], "rb") as fh:
        raw = fh.read()
    nat = native.tokenize_native(raw)
    py = spcat._tokenize_python([ln for ln in raw.decode().splitlines() if ln.strip()])
    jnat = jax_native(raw)
    assert jnat is not None
    assert nat.keys() == py.keys() == jnat.keys()
    for k in nat:
        assert nat[k].dtype == py[k].dtype == jnat[k].dtype, k
        np.testing.assert_array_equal(nat[k], py[k], err_msg=k)
        np.testing.assert_array_equal(nat[k], jnat[k], err_msg=k)
    assert len(spcat.parse_spcat(catalogs[name])) == nat["frequency"].size


def test_native_tokenizer_off_falls_back(catalogs, monkeypatch):
    """CHA1_NATIVE=0 turns the native tokenizer off: tokenize_native
    returns None and parse_spcat gives the same catalog through the
    Python tokenizer."""
    from cha1_mcmc_tpu_torch.catalogs import native, spcat

    with_native = spcat.parse_spcat(catalogs["hc5n"])
    monkeypatch.setenv("CHA1_NATIVE", "0")
    native._load.cache_clear()
    try:
        assert native.tokenize_native(b"") is None and not native.native_available()
        without = spcat.parse_spcat(catalogs["hc5n"])
    finally:
        native._load.cache_clear()
    for f in dataclasses.fields(without):
        a, b = getattr(without, f.name), getattr(with_native, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
