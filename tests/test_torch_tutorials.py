"""The port's tutorials (``mbrl_tpu_torch/examples/tutorial_*.py``) on the CPU,
each against the JAX package's threshold at the same size.

- CEM on the negated Rosenbrock function at the tutorial's defaults (100
  iterations of 500): the best value above -0.1 in both packages (the
  threshold of tests/test_optimizers.py::test_cem_rosenbrock; optimum 0).
- The 1-D ensemble fit, cut from 500 epochs to 200: the ensemble mean's RMSE
  against sin(x) below 0.25 and the aleatoric variance smaller where the
  injected noise is (0.05 left of 0, 0.20 right of it). The JAX package's
  tutorial meets the same at 200 epochs (RMSE 0.12 on this seed); it is not
  run here, to keep the test file's time.
- PETS on the continuous cartpole (``test_torch_tutorial_pets.py``).
"""

import pytest
import torch

from mbrl_tpu.examples import tutorial_cem_rosenbrock as jax_rosenbrock
from mbrl_tpu_torch.examples import tutorial_cem_rosenbrock, tutorial_fit_ensemble_1d

ROSENBROCK_THRESHOLD = -0.1
FIT_EPOCHS, FIT_RMSE = 200, 0.25


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the test workers share the
    CPU, and a pool of threads per worker over small products slows them all
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cem_rosenbrock_reaches_the_valley_floor():
    best = tutorial_cem_rosenbrock.main(device="cpu")
    jbest = jax_rosenbrock.main()
    assert best > ROSENBROCK_THRESHOLD and jbest > ROSENBROCK_THRESHOLD, (best, jbest)
    assert best <= 0.0


def _aleatoric(printed: str):
    """The mean aleatoric variances left and right of 0, as main prints them."""
    left, right = printed.split("aleatoric var left ")[-1].split(" (")[0].split(" vs right ")
    return float(left), float(right)


def test_fit_ensemble_1d_separates_the_noise_levels(capsys):
    rmse = tutorial_fit_ensemble_1d.main(num_epochs=FIT_EPOCHS, device="cpu")
    left, right = _aleatoric(capsys.readouterr().out)
    assert rmse < FIT_RMSE and left < right
