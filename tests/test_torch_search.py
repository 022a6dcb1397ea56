"""The port's hyperparameter search (a NumPy copy of the JAX package's
``utils/search.py``) and its sweep CLI (mirrors tests/test_search.py):
the same space grammar, the same suggestions as JAX's bit for bit for a
seed, the concurrent runners with a stub trainer, and a real grid sweep
over the port's ``train_signal_regression --device cpu`` subprocesses."""

import os
import time

import numpy as np
import pytest

import fourier_feature_nets_tpu.utils.search as jax_search
from fourier_feature_nets_torch.cli import sweep as sweep_mod
from fourier_feature_nets_torch.utils.search import (
    BayesianSearch,
    _GaussianProcess,
    parse_space,
)

SPACE = ("learning-rate=loguniform(1e-5,1e-2);"
         "num-channels=choice(64,128,256);"
         "crop-steps=quniform(0,1000);"
         "anneal-start=uniform(0.0,1.0)")


class TestSearchSpace:
    def test_parse_and_roundtrip(self):
        space = parse_space(SPACE)
        assert space.names == ["learning-rate", "num-channels",
                               "crop-steps", "anneal-start"]
        params = {"learning-rate": 1e-3, "num-channels": 128,
                  "crop-steps": 500, "anneal-start": 0.25}
        decoded = space.decode(space.encode(params))
        assert decoded["num-channels"] == 128
        assert decoded["crop-steps"] == 500
        assert decoded["learning-rate"] == pytest.approx(1e-3, rel=1e-6)
        assert decoded["anneal-start"] == pytest.approx(0.25, abs=1e-9)

    def test_sampling_respects_bounds(self):
        space = parse_space("lr=loguniform(1e-4,1e-1);c=choice(a,b)")
        rng = np.random.default_rng(0)
        for _ in range(64):
            params = space.sample(rng)
            assert 1e-4 <= params["lr"] <= 1e-1
            assert params["c"] in ("a", "b")

    @pytest.mark.parametrize("spec", ["lr=normal(0,1)", "",
                                      "lr=loguniform(0,1)"])
    def test_bad_specs_raise(self, spec):
        with pytest.raises(ValueError):
            parse_space(spec)


def _objective(params):
    x = np.log10(params["learning-rate"]) + 3.0
    return -(x * x + (params["anneal-start"] - 0.4) ** 2
             + (params["num-channels"] != 128) * 0.1
             + abs(params["crop-steps"] - 300) / 1000)


@pytest.mark.parametrize("seed", [0, 7])
def test_suggestions_equal_jax(seed):
    """The whole loop, random phase and GP phase with pending
    (constant-liar) points: every suggestion and the best equal JAX's."""
    ours = BayesianSearch(parse_space(SPACE), seed=seed, num_initial=3)
    ref = jax_search.BayesianSearch(jax_search.parse_space(SPACE),
                                    seed=seed, num_initial=3)
    for _ in range(5):
        batch = [ours.suggest(), ours.suggest()]
        ref_batch = [ref.suggest(), ref.suggest()]
        assert batch == ref_batch
        for params in batch:
            ours.observe(params, _objective(params))
            ref.observe(params, _objective(params))
    assert ours.best() == ref.best()


class TestBayesianSearch:
    def test_beats_random_on_smooth_objective(self):
        spec = "x=uniform(0,1);y=uniform(0,1)"

        def objective(p):
            return -((p["x"] - 0.31) ** 2 + (p["y"] - 0.77) ** 2)

        budget = 24
        bayes = BayesianSearch(parse_space(spec), seed=0)
        for _ in range(budget):
            params = bayes.suggest()
            bayes.observe(params, objective(params))
        _, bayes_best = bayes.best()
        rng = np.random.default_rng(0)
        space = parse_space(spec)
        random_best = max(objective(space.sample(rng))
                          for _ in range(budget))
        assert bayes_best > random_best
        assert bayes_best > -0.01

    def test_constant_liar_separates_concurrent_suggestions(self):
        search = BayesianSearch(parse_space("x=uniform(0,1)"), seed=1,
                                num_initial=2)
        for _ in range(4):
            params = search.suggest()
            search.observe(params, -(params["x"] - 0.5) ** 2)
        batch = [search.suggest() for _ in range(3)]
        assert len(search.pending) == 3
        xs = sorted(p["x"] for p in batch)
        assert xs[1] - xs[0] > 1e-4 or xs[2] - xs[1] > 1e-4

    def test_quniform_pending_points_are_released(self):
        search = BayesianSearch(parse_space("channels=quniform(64,256);"
                                            "lr=loguniform(1e-5,1e-2)"),
                                num_initial=3, seed=0)
        for _ in range(12):
            params = search.suggest()
            assert len(search.pending) == 1
            search.observe(params, -float(params["channels"]))
            assert search.pending == []

    def test_observe_releases_one_of_identical_pending(self):
        search = BayesianSearch(parse_space("lr=uniform(0,1)"),
                                num_initial=8, seed=1)
        params = search.suggest()
        search.pending.append(search.pending[0].copy())
        search.observe(params, 1.0)
        assert len(search.pending) == 1

    def test_failed_runs_are_dropped(self):
        search = BayesianSearch(parse_space("x=uniform(0,1)"), seed=2,
                                num_initial=1)
        search.observe(search.suggest(), float("-inf"))
        assert search.best() is None
        search.observe(search.suggest(), 1.0)
        assert search.best()[1] == 1.0


def test_gp_predict_interpolates():
    x = np.linspace(0, 1, 9)[:, None]
    y = np.sin(2 * np.pi * x[:, 0])
    gp = _GaussianProcess(length_scale=0.3).fit(x, y)
    mu, sigma = gp.predict(x)
    np.testing.assert_allclose(mu, y, atol=0.05)
    assert (sigma < 0.2).all()
    mu_mid, _ = gp.predict(np.asarray([[0.5]]))
    assert abs(mu_mid[0]) < 0.3


class TestSweepRunner:
    def test_concurrent_grid_sweep(self, tmp_path, monkeypatch):
        """Two runs overlap in time and the best value is chosen."""
        spans = {}

        def fake_launch(trainer, run_dir, trainer_args, overrides,
                        extra_env=None):
            os.makedirs(run_dir, exist_ok=True)
            value = float(overrides["learning-rate"])
            start = time.perf_counter()
            time.sleep(0.4)
            spans[value] = (start, time.perf_counter())
            with open(os.path.join(run_dir, "log.txt"), "w") as file:
                file.write("step\ttimestamp\tpsnr_train\tpsnr_val\n")
                file.write(f"100\t1.0\t20.0\t{20 + value * 1000}\n")
            return 0

        monkeypatch.setattr(sweep_mod, "_launch", fake_launch)
        best, scores = sweep_mod.run_sweep(
            "train_voxels", "learning-rate", ["0.001", "0.01"],
            str(tmp_path), [], max_concurrent=2)
        assert best == "0.01"
        assert scores["0.01"] == pytest.approx(30.0)
        (s1, e1), (s2, e2) = spans[0.001], spans[0.01]
        assert s1 < e2 and s2 < e1

    def test_bayesian_search_loop_with_stub_trainer(self, tmp_path,
                                                    monkeypatch):
        def fake_launch(trainer, run_dir, trainer_args, overrides,
                        extra_env=None):
            os.makedirs(run_dir, exist_ok=True)
            lr = float(overrides["learning-rate"])
            score = 30.0 - (np.log10(lr) + 3.0) ** 2
            with open(os.path.join(run_dir, "log.txt"), "w") as file:
                file.write("step\ttimestamp\tpsnr_train\tpsnr_val\n")
                file.write(f"100\t1.0\t20.0\t{score}\n")
            return 0

        monkeypatch.setattr(sweep_mod, "_launch", fake_launch)
        best_params, best_score, trials = sweep_mod.run_search(
            "train_voxels", "learning-rate=loguniform(1e-5,1e-1)",
            str(tmp_path / "sweep"), [], max_runs=10, max_concurrent=2,
            seed=3)
        assert len(trials) == 10
        assert best_score > 28.0
        assert 1e-5 <= best_params["learning-rate"] <= 1e-1
        assert len([d for d in os.listdir(tmp_path / "sweep")
                    if d.startswith("trial_")]) == 10

    def test_trainers_and_metrics_are_jaxs(self):
        from fourier_feature_nets_tpu.cli import sweep as jax_sweep
        assert sweep_mod.TRAINERS == jax_sweep.TRAINERS
        args = sweep_mod._parse_args(["train_nerf", "--sweep-dir", "d"])
        assert args.metric == "psnr_val" and args.max_concurrent == 1


def test_best_metric_from_log(tmp_path, capsys):
    path = tmp_path / "log.txt"
    path.write_text('{"args": 1}\n\nstep\ttrain_loss\tval_loss\n'
                    "0\t0.5\t0.6\n10\t0.1\t0.2\n20\t0.2\tnan-ish\n")
    assert sweep_mod.best_metric_from_log(str(path), "val_loss") == -0.2
    assert sweep_mod.best_metric_from_log(str(path), "psnr_val") == \
        float("-inf")
    assert "not found" in capsys.readouterr().err


def test_sweep_cli_end_to_end_subprocess(tmp_path, monkeypatch):
    """A real grid sweep of two of the port's signal-regression trainers
    on the CPU, two at a time, from a working directory outside the
    checkout: both write their log, and the sweep names the best."""
    sweep_dir = tmp_path / "sweep"
    monkeypatch.chdir(tmp_path)
    best, scores = sweep_mod.run_sweep(
        "train_signal_regression", "num-channels", ["16", "32"],
        str(sweep_dir),
        ["multifreq", "--device", "cpu", "--fourier", "--no-plot",
         "--num-steps", "20", "--report-interval", "10"],
        metric="val_loss", max_concurrent=2)
    assert sorted(os.listdir(sweep_dir)) == ["num_channels_16",
                                             "num_channels_32"]
    for run in os.listdir(sweep_dir):
        header = open(sweep_dir / run / "log.txt").readline().split()
        assert header == ["step", "train_loss", "val_loss"]
    assert all(np.isfinite(v) for v in scores.values())
    assert best in ("16", "32")
