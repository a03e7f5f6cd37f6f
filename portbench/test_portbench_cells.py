"""Each cell at a toy size on the CPU, through the port's plain kernel
versions: a sound run is correct and prints its result line; the control
(the reference in TF32 products) and each fault the cell can have, planted
under the timed path, come out not correct."""
import json
import pathlib

import pytest
import torch

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = {
    "mbpo_walker.rollout": {"start_states": 500, "capacity": 2_000, "real_rows": 3_000},
    "mbpo_hum.rollout": {"start_states": 100, "capacity": 12_500, "real_rows": 1_000},
}
SEED = 2**32 + 17


def run(cell, mode="program", seconds=0.3):
    return harness.run_cell(ROOT, cell, SEED, seconds, False, device="cpu",
                            scale=SCALE[cell], mode=mode)


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_a_sound_run_is_correct_and_prints_its_line(cell, capsys):
    result = run(cell)
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"imagined_rows_per_s", "setup_s"}
    assert line["device"]["platform"] == "cpu"
    assert err.strip().splitlines()[-1].startswith("check model_gap ")
    for name, check in line["checks"].items():
        assert check["value"] <= check["limit"], name


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_the_control_is_not_correct(cell):
    result = run(cell, mode="control")
    assert result["correct"] is False and result["failed"] >= 1


def _step_returns_its_state(monkeypatch):
    from mbrl_tpu_torch.models.model_env import ModelEnv

    step = ModelEnv.step

    def broken(self, state, actions, model_state, generator, sample=False):
        next_obs, rewards, terminated, ms = step(self, state, actions, model_state, generator,
                                                 sample)
        return model_state["obs"], rewards, terminated, ms

    monkeypatch.setattr(ModelEnv, "step", broken)


def _half_the_batch_left_out(monkeypatch):
    from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer

    add = DeviceReplayBuffer.add_batch_masked

    def broken(self, state, obs, act, next_obs, reward, mask, valid):
        half = torch.arange(valid.numel(), device=valid.device) < valid.numel() // 2
        return add(self, state, obs, act, next_obs, reward, mask, valid & half)

    monkeypatch.setattr(DeviceReplayBuffer, "add_batch_masked", broken)


def _an_action_altered(monkeypatch):
    from mbrl_tpu_torch.planning.sac import SAC

    act = SAC.act_tensor

    def broken(self, policy, obs, generator, sample=True):
        out = act(self, policy, obs, generator, sample).clone()
        out[obs.shape[0] // 3, 0] += 1e-3
        return out

    monkeypatch.setattr(SAC, "act_tensor", broken)


@pytest.mark.parametrize("cell", sorted(SCALE))
@pytest.mark.parametrize("fault", [_step_returns_its_state, _half_the_batch_left_out,
                                   _an_action_altered], ids=lambda f: f.__name__.strip("_"))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert result["correct"] is False and result["failed"] >= 1
