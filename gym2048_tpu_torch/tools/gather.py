"""Interactive human-play data collector (counterpart of
``gym2048_tpu/tools/gather.py``).

Mirrors the reference ``gather_training_data.py``: a pygame window showing
the rendered board, a live bar chart of the model's action probabilities
and a line plot of evaluation scores; the model plays its argmax action
automatically, deferring to the human when (a) confidence < 0.5, (b) the
predicted move is illegal (probed on a scratch board), or (c) the move
would lose a >=64 tile from a corner. Only human-entered legal moves are
recorded; after each episode the model (``Game2048Model`` on ``--device``)
is retrained on all collected data (8x augmented) and re-evaluated.

Keys: arrows = move, a = accept model move, r = random move,
e = end episode, q = quit.

A host tool: ``pygame`` and ``matplotlib`` are imported inside
:func:`main` and :func:`gather_episode` (and the chart helper) only, so the
module imports without them.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np

GRID = 70


def high_tile_in_corner(board: np.ndarray) -> bool:
    """A tile >= 64 equal to the board max sits in a corner
    (reference gather_training_data.py:77-87)."""
    board = np.asarray(board)
    highest = board.max()
    if highest < 64:
        return False
    eq = board == highest
    return bool(eq[[0, 0, -1, -1], [0, -1, 0, -1]].any())


def _charts(fig, predictions, fig2, results):
    import matplotlib.backends.backend_agg as agg

    fig.clf()
    ax = fig.gca()
    ax.set_xlabel("Action")
    ax.set_ylabel("Probability")
    ax.set_ylim([0, 1])
    ax.bar(["Up", "Right", "Down", "Left"], predictions)
    fig.tight_layout()
    canvas = agg.FigureCanvasAgg(fig)
    canvas.draw()
    bar_raw = bytes(canvas.buffer_rgba())

    fig2.clf()
    ax2 = fig2.gca()
    ax2.set_xlabel("Episode")
    ax2.set_ylabel("Score")
    ax2.set_xlim([0, max(1, len(results))])
    ax2.plot(range(len(results)), [r["Average score"] for r in results], label="Average score")
    ax2.plot(range(len(results)), [r["Max score"] for r in results], label="Max score")
    ax2.legend()
    fig2.tight_layout()
    canvas2 = agg.FigureCanvasAgg(fig2)
    canvas2.draw()
    line_raw = bytes(canvas2.buffer_rgba())
    return bar_raw, line_raw


class EndingEpisode(Exception):
    pass


class Quitting(Exception):
    pass


def gather_episode(env, predict, data, results, screen, figs, seed=None):
    """One interactive episode; records human-entered legal moves."""
    import pygame

    from gym2048_tpu_torch.core import rules_np
    from gym2048_tpu_torch.env.adapter import unstack_np

    fig, fig2 = figs
    observation, _ = env.reset(seed=seed)
    print("Use cursor keys to play, q to quit")
    try:
        while True:
            env.render()
            board_array = env.render(mode="rgb_array")
            surf = pygame.surfarray.make_surface(board_array.swapaxes(0, 1))
            screen.blit(surf, (0, 0))

            predictions = predict(observation)
            predicted_action = int(np.argmax(predictions))
            ranked = sorted(zip(["up", "right", "down", "left"], predictions),
                            key=lambda x: x[1], reverse=True)
            for name, prob in ranked:
                print(f"{name}: {prob:.3f}")

            bar_raw, line_raw = _charts(fig, predictions, fig2, results)
            chart = pygame.image.fromstring(bar_raw, (4 * GRID, 4 * GRID), "RGBA")
            screen.blit(chart, (4 * GRID, 0))
            chart2 = pygame.image.fromstring(line_raw, (4 * GRID, 4 * GRID), "RGBA")
            screen.blit(chart2, (8 * GRID, 0))
            pygame.display.update()

            board = unstack_np(observation)
            confidence = float(np.max(predictions))
            after, _, predicted_legal = rules_np.move(board, predicted_action)
            lost_corner = high_tile_in_corner(board) and not high_tile_in_corner(after)
            if confidence < 0.5:
                print(f"***Confidence < 50%: {confidence}***")
            if not predicted_legal:
                print("***Predicted is illegal.***")
            if lost_corner:
                print("***Lost high corner tile.***")

            record_action = False
            if confidence < 0.5 or not predicted_legal or lost_corner:
                action = None
                while action is None:
                    event = pygame.event.wait()
                    if event.type == pygame.QUIT:
                        raise Quitting
                    if event.type != pygame.KEYDOWN:
                        continue
                    keymap = {pygame.K_UP: 0, pygame.K_RIGHT: 1,
                              pygame.K_DOWN: 2, pygame.K_LEFT: 3}
                    if event.key in keymap:
                        action = keymap[event.key]
                        record_action = True
                    elif event.key == pygame.K_e:
                        raise EndingEpisode
                    elif event.key == pygame.K_q:
                        raise Quitting
                    elif event.key == pygame.K_a:
                        action = predicted_action
                    elif event.key == pygame.K_r:
                        action = random.randrange(4)
            else:
                action = predicted_action

            print(f"Selected action {action}")
            new_observation, reward, terminated, truncated, info = env.step(action)
            done = terminated or truncated
            if record_action and not info["illegal_move"]:
                data.add(unstack_np(observation), action, reward,
                         unstack_np(new_observation), done)
            else:
                print("Not recording move")
            observation = new_observation
            print()
            if done:
                env.render()
                print("End of game")
                break
    except EndingEpisode:
        print("Ending episode...")
    return data


def main(argv=None) -> None:
    import pygame
    import torch

    from gym2048_tpu_torch import interop
    from gym2048_tpu_torch.data import TrainingData
    from gym2048_tpu_torch.env import adapter
    from gym2048_tpu_torch.models import Game2048Model
    from gym2048_tpu_torch.train import BCConfig, BCTrainer
    from gym2048_tpu_torch.train.eval import evaluate_model, make_predict_fn
    from gym2048_tpu_torch.utils.checkpoint import load_model, save_model

    p = argparse.ArgumentParser()
    p.add_argument("--input", "-i", default=None,
                   help="Existing training data CSV to start from")
    p.add_argument("--model", "-m", default=None, help="Pre-trained model to start from")
    p.add_argument("--reload-results", default=None)
    timestamp = int(time.time())
    p.add_argument("--output", "-o", default=f"data_{timestamp}.csv")
    p.add_argument("--output-model", default=f"model_{timestamp}.pkl")
    p.add_argument("--results", "-r", default=f"results_{timestamp}.json")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--residual-blocks", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    env = adapter.Game2048Env()
    device = torch.device(args.device)
    model = Game2048Model(filters=args.filters, residual_blocks=args.residual_blocks,
                          device=device)
    trainer = BCTrainer(model, BCConfig(epochs=3))
    if args.model:
        variables, _meta = load_model(args.model)
        model.load_state_dict(interop.resnet_state_dict(variables))
    else:
        trainer.init_model(torch.Generator(device=device).manual_seed(0))

    pygame.init()
    screen = pygame.display.set_mode((12 * GRID, 4 * GRID), 0, 32)
    pygame.font.init()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figs = (plt.figure(figsize=[4 * GRID / 100, 4 * GRID / 100], dpi=100),
            plt.figure(figsize=[4 * GRID / 100, 4 * GRID / 100], dpi=100))

    def retrain(data):
        train_from = data.copy()
        train_from.augment()
        trainer.fit(train_from.get_x_exponents(), train_from.get_y_digit())

    alldata = TrainingData()
    if args.input:
        alldata.import_csv(args.input)
        retrain(alldata)

    if args.reload_results:
        with open(args.reload_results) as f:
            results = json.load(f)
    else:
        results = [evaluate_model(make_predict_fn(model.eval()), 10, 0.0)]

    try:
        while True:
            predict = make_predict_fn(model.eval())
            gather_episode(env, lambda obs: predict(obs), alldata, results, screen, figs,
                           seed=args.seed)
            retrain(alldata)
            results.append(evaluate_model(make_predict_fn(model.eval()), 10, 0.0))
            print(f"Got {alldata.size()} data values")
    except Quitting:
        print("Quitting...")

    print(results)
    if results:
        with open(args.results, "w") as f:
            json.dump(results, f, indent=4)
    if alldata.size():
        alldata.export_csv(args.output)
    if args.output_model:
        save_model(args.output_model, interop.resnet_variables(model),
                   {"filters": args.filters, "residual_blocks": args.residual_blocks,
                    "model": "Game2048Model"})


if __name__ == "__main__":
    main()
