"""The port's human-play collector (gym2048_tpu_torch.tools.gather) against
gym2048_tpu.tools.gather: the corner rule, a headless import, and one
scripted episode under SDL's dummy video driver (the same key presses and
the same fixed, unconfident prediction, so every move is asked of the
"human") that records the same rows as JAX's ``gather_episode``."""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gym2048_tpu.data import TrainingData as JTrainingData
from gym2048_tpu.env import adapter as jadapter
from gym2048_tpu.tools import gather as jgather
from gym2048_tpu_torch.data import TrainingData
from gym2048_tpu_torch.env import adapter
from gym2048_tpu_torch.tools import gather

ROOT = Path(__file__).resolve().parent.parent


def test_high_tile_in_corner_matches_jax():
    rng = np.random.default_rng(0)
    boards = [2 ** rng.integers(0, 9, (4, 4)) * (rng.random((4, 4)) < 0.7) for _ in range(300)]
    for corner in ((0, 0), (0, 3), (3, 0), (3, 3), (1, 1)):
        b = np.zeros((4, 4), int)
        b[corner] = 64
        boards.append(b)
    boards.append(np.full((4, 4), 32))
    got = [gather.high_tile_in_corner(b) for b in boards]
    assert got == [jgather.high_tile_in_corner(b) for b in boards]
    assert any(got) and not all(got)


def test_module_imports_headless():
    code = ("import sys; sys.modules['pygame'] = None; sys.modules['matplotlib'] = None; "
            "from gym2048_tpu_torch.tools import gather; assert callable(gather.main); "
            "print('HEADLESS')")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "HEADLESS" in done.stdout


@pytest.fixture
def pygame_screen(monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    pygame = pytest.importorskip("pygame")
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pygame.init()
    screen = pygame.display.set_mode((12 * gather.GRID, 4 * gather.GRID), 0, 32)
    figs = tuple(plt.figure(figsize=[4 * gather.GRID / 100] * 2, dpi=100) for _ in range(2))
    yield pygame, screen, figs
    for fig in figs:
        plt.close(fig)
    pygame.quit()


def _rows(data):
    return [np.asarray(x) for x in (data.get_x(), data.get_y_digit(), data.get_reward(),
                                    data.get_next_x(), data.get_done())]


def test_scripted_episode_records_the_rows_jax_records(pygame_screen, capsys):
    pygame, screen, figs = pygame_screen
    arrows = (pygame.K_UP, pygame.K_RIGHT, pygame.K_DOWN, pygame.K_LEFT)
    # 14 moves that are legal from seed 5's game, then the model's move
    # and a random one (neither recorded), then the end of the episode
    keys = [arrows[a] for a in (0, 3, 0, 1, 2, 3, 0, 3, 0, 1, 2, 3, 0, 3)]
    keys += [pygame.K_a, pygame.K_r, pygame.K_e]

    def predict(observation):
        return np.array([0.3, 0.2, 0.25, 0.25], np.float32)  # unconfident: ask every move

    def play(module, env, data):
        pygame.event.clear()
        for key in keys:
            pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=key))
        pygame.event.post(pygame.event.Event(pygame.QUIT))  # a backstop: never wait forever
        random.seed(11)
        return module.gather_episode(env, predict, data, [{"Average score": 1.0,
                                                           "Max score": 2.0}],
                                     screen, figs, seed=5)

    want = play(jgather, jadapter.Game2048Env(), JTrainingData())
    got = play(gather, adapter.Game2048Env(), TrainingData())
    out = capsys.readouterr().out
    assert out.count("Ending episode...") + out.count("End of game") == 2
    assert got.size() == want.size() == 14  # the arrows are recorded, 'a' and 'r' are not
    for g, w in zip(_rows(got), _rows(want)):
        np.testing.assert_array_equal(g, w)
    assert os.environ["SDL_VIDEODRIVER"] == "dummy"
