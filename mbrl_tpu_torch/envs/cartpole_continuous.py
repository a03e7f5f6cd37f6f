"""Continuous-action cartpole, the PETS tutorial environment (counterpart of
``mbrl_tpu/envs/cartpole_continuous.py``).

The classic cartpole balancing task with the discrete push replaced by a
continuous force in [-1, 1] scaled by ``force_mag``; Euler integration with the
standard constants; the episode ends when pole angle or cart position leave
their thresholds. Plain numpy with the port's own ``Box`` spaces; ``reset`` and
``step`` return what a ``gymnasium`` environment returns.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from mbrl_tpu_torch.envs.spaces import Box


class CartPoleEnv:
    def __init__(self, render_mode: Optional[str] = None):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02

        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4

        high = np.array(
            [
                self.x_threshold * 2,
                np.finfo(np.float32).max,
                self.theta_threshold_radians * 2,
                np.finfo(np.float32).max,
            ],
            dtype=np.float32,
        )
        self.action_space = Box(-1.0, 1.0, shape=(1,), dtype=np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)

        self.render_mode = render_mode
        self.np_random = np.random.default_rng()
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated: Optional[int] = None

    def _dynamics(self, state: np.ndarray, force: float) -> np.ndarray:
        x, x_dot, theta, theta_dot = state
        costheta = math.cos(theta)
        sintheta = math.sin(theta)
        temp = (
            force + self.polemass_length * theta_dot**2 * sintheta
        ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        return np.array(
            [
                x + self.tau * x_dot,
                x_dot + self.tau * xacc,
                theta + self.tau * theta_dot,
                theta_dot + self.tau * thetaacc,
            ]
        )

    def step(self, action: np.ndarray) -> Tuple[np.ndarray, float, bool, bool, dict]:
        force = self.force_mag * float(np.clip(action, -1.0, 1.0)[0])
        self.state = self._dynamics(self.state, force)
        x, _, theta, _ = self.state

        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = 0.0
        return np.asarray(self.state, np.float32), reward, terminated, False, {}

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps_beyond_terminated = None
        return np.asarray(self.state, np.float32), {}

    def render(self):
        return None

    def close(self) -> None:
        pass
