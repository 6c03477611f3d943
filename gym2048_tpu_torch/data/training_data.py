"""Host-side training-data container with reference-exact semantics (a
copy of ``gym2048_tpu/data/training_data.py``, which cannot be imported
without JAX; its CSV paths use the port's :mod:`gym2048_tpu_torch.native`).

Mirrors the full public API of the reference ``training_data`` class
(training_data.py:22-322) — transition storage, 8x symmetry augmentation,
reward math, and the 35/36-column CSV schema — so CSV files are
interchangeable between the reference, the JAX package and the port.
Differences from the reference are implementation only:

* ``add`` is amortised O(1) (growing buffers) instead of ``np.append``
  per call (O(n^2) in the reference);
* ``import_csv`` parses the file once instead of five times;
* extra device-facing conveniences: exponent-board views and construction
  from device rollouts.

Boards are stored as tile *values* ``(N, 4, 4)`` ints — the reference's
convention and the CSV schema's. ``shuffle`` draws from numpy's global
generator, as in the reference.
"""

from __future__ import annotations

import copy as _copy

import numpy as np


def stack(flat: np.ndarray, layers: int = 16) -> np.ndarray:
    """Value boards ``(N, 4, 4)`` -> ``(N, 4, 4, layers)`` one-hot.

    Channels mark tiles 2^1..2^layers; empty cells encode to all-zero
    (reference training_data.py:8-20 — note: no empty channel, unlike the
    env observation).
    """
    representation = 2 ** (np.arange(layers, dtype=int) + 1)
    return (
        np.asarray(flat)[..., np.newaxis] == representation
    ).astype(int)


class TrainingData:
    """Parallel arrays of (board, action, reward, next_board, done)."""

    def __init__(self) -> None:
        self._x = np.empty([0, 4, 4], dtype=int)
        self._y_digit = np.zeros([0, 1], dtype=int)
        self._reward = np.zeros([0, 1], dtype=float)
        self._next_x = np.empty([0, 4, 4], dtype=int)
        self._done = np.empty([0, 1], dtype=bool)
        # growth buffers for amortised O(1) add()
        self._pending: list[tuple] = []

    # ------------------------------------------------------------- internal
    def _flush(self) -> None:
        if not self._pending:
            return
        xs, ys, rs, nxs, ds = zip(*self._pending)
        self._x = np.concatenate([self._x, np.stack(xs)])
        self._y_digit = np.concatenate(
            [self._y_digit, np.asarray(ys, dtype=int).reshape(-1, 1)]
        )
        self._reward = np.concatenate(
            [self._reward, np.asarray(rs, dtype=float).reshape(-1, 1)]
        )
        self._next_x = np.concatenate([self._next_x, np.stack(nxs)])
        self._done = np.concatenate(
            [self._done, np.asarray(ds, dtype=bool).reshape(-1, 1)]
        )
        self._pending.clear()
        self._check_lengths()

    def _check_lengths(self) -> None:
        n = self._x.shape[0]
        assert self._y_digit.shape[0] == n
        assert self._reward.shape[0] == n
        assert self._next_x.shape[0] == n
        assert self._done.shape[0] == n

    # --------------------------------------------------------------- basics
    def copy(self) -> "TrainingData":
        self._flush()
        return _copy.deepcopy(self)

    def add(self, board, action, reward, next_board=None, done=False) -> None:
        """Append one transition (reference training_data.py:65-83)."""
        assert reward is not None
        self._pending.append(
            (
                np.reshape(board, (4, 4)),
                int(np.asarray(action).reshape(())),
                float(np.asarray(reward).reshape(())),
                np.reshape(next_board, (4, 4)),
                bool(np.asarray(done).reshape(())),
            )
        )

    def size(self) -> int:
        self._flush()
        return self._x.shape[0]

    def get_n(self, n: int):
        """Transition number n as a 5-tuple."""
        self._flush()
        return (
            self._x[n, :, :],
            self._y_digit[n, :],
            self._reward[n, :],
            self._next_x[n, :, :],
            self._done[n, :],
        )

    # -------------------------------------------------------------- getters
    def get_x(self) -> np.ndarray:
        self._flush()
        return self._x

    def get_x_stacked(self) -> np.ndarray:
        return stack(self.get_x())

    def get_y_digit(self) -> np.ndarray:
        self._flush()
        return self._y_digit

    def get_y_one_hot(self) -> np.ndarray:
        items = self.size()
        one_hot = np.zeros((items, 4))
        one_hot[np.arange(items), self._y_digit.reshape(-1)] = 1
        return one_hot

    def get_reward(self) -> np.ndarray:
        self._flush()
        return self._reward

    def get_next_x(self) -> np.ndarray:
        self._flush()
        return self._next_x

    def get_done(self) -> np.ndarray:
        self._flush()
        return self._done

    def get_total_reward(self) -> float:
        return float(np.sum(self.get_reward()))

    def get_highest_tile(self):
        """Highest tile on any next-board (reference :93-95)."""
        return np.max(self.get_next_x())

    # ---------------------------------------------------------- reward math
    def log2_rewards(self) -> None:
        """log2 of positive rewards, 0 for zero rewards (reference :97-102)."""
        r = self.get_reward().reshape(-1)
        out = np.where(r > 0, np.log2(np.maximum(r, 1e-30)), 0.0)
        self._reward = out.reshape(-1, 1).astype(float)

    def get_discounted_return(self, gamma: float = 0.9) -> np.ndarray:
        """Reverse-accumulated return, reset at done (reference :104-124)."""
        r = self.get_reward().reshape(-1)
        d = self.get_done().reshape(-1)
        out = np.zeros_like(r, dtype=float)
        prev = 0.0
        for i in range(len(r) - 1, -1, -1):
            prev = r[i] + (0.0 if d[i] else gamma * prev)
            out[i] = prev
        return out.reshape(-1, 1)

    def normalize_boards(self, mean=None, sd=None) -> None:
        boards = self.get_x()
        if mean is None:
            mean = np.mean(boards)
        if sd is None:
            sd = np.std(boards)
        self._x = (boards - mean) / sd
        self._next_x = (self.get_next_x() - mean) / sd

    def normalize_rewards(self, mean=None, sd=None) -> None:
        rewards = self.get_reward()
        if mean is None:
            mean = np.mean(rewards)
        if sd is None:
            sd = np.std(rewards)
        self._reward = (rewards - mean) / sd

    # ------------------------------------------------------ set operations
    def merge(self, other: "TrainingData") -> None:
        self._flush()
        self._x = np.concatenate((self._x, other.get_x()))
        self._y_digit = np.concatenate((self._y_digit, other.get_y_digit()))
        self._reward = np.concatenate((self._reward, other.get_reward()))
        self._next_x = np.concatenate((self._next_x, other.get_next_x()))
        self._done = np.concatenate((self._done, other.get_done()))
        self._check_lengths()

    def split(self, split: float = 0.5):
        self._flush()
        point = int(self.size() * split)
        a, b = TrainingData(), TrainingData()
        for name in ("_x", "_y_digit", "_reward", "_next_x", "_done"):
            arr = getattr(self, name)
            setattr(a, name, arr[:point])
            setattr(b, name, arr[point:])
        return a, b

    def sample(self, index_list) -> "TrainingData":
        self._flush()
        idx = np.asarray(index_list)
        out = TrainingData()
        for name in ("_x", "_y_digit", "_reward", "_next_x", "_done"):
            setattr(out, name, getattr(self, name)[idx])
        return out

    def _update(self, indices) -> None:
        self._flush()
        for name in ("_x", "_y_digit", "_reward", "_next_x", "_done"):
            setattr(self, name, getattr(self, name)[indices])
        self._check_lengths()

    def shuffle(self) -> None:
        self._update(np.random.permutation(self.size()))

    def make_boards_unique(self) -> None:
        """Deduplicate by board, keeping first occurrences in order."""
        _, x_indices = np.unique(self.get_x(), return_index=True, axis=0)
        self._update(np.sort(x_indices))

    # --------------------------------------------------------- augmentation
    def hflip(self) -> None:
        """Horizontal flip; swaps actions 1<->3 (reference :257-272)."""
        self._flush()
        self._x = np.flip(self._x, 2)
        y = self._y_digit.copy()
        self._y_digit = np.where(y == 1, 3, np.where(y == 3, 1, y))
        self._next_x = np.flip(self._next_x, 2)
        self._check_lengths()

    def rotate(self, k: int) -> None:
        """Rotate by k*90 degrees; actions shift by k (reference :274-279)."""
        self._flush()
        self._x = np.rot90(self._x, k=k, axes=(2, 1))
        self._y_digit = np.mod(self._y_digit + k, 4)
        self._next_x = np.rot90(self._next_x, k=k, axes=(2, 1))
        self._check_lengths()

    def augment(self) -> None:
        """8x dihedral augmentation in reference order (reference :281-299)."""
        other = self.copy()
        other.hflip()
        self.merge(other)
        rotations = []
        for k in (1, 2, 3):
            r = self.copy()
            r.rotate(k)
            rotations.append(r)
        for r in rotations:
            self.merge(r)
        self._check_lengths()

    # ------------------------------------------------------------------ CSV
    def construct_header(self, add_returns: bool = False) -> list[str]:
        header = [f"{m}-{n}" for m in range(1, 5) for n in range(1, 5)]
        header += ["action", "reward"]
        header += [f"next {m}-{n}" for m in range(1, 5) for n in range(1, 5)]
        header.append("done")
        if add_returns:
            header.append("return")
        return header

    def import_csv(self, filename) -> None:
        """Load the 35-column schema (a trailing return column is ignored).

        Uses the native C++ parser when available (one pass, ~20x faster
        than np.loadtxt); otherwise a single np.loadtxt parse instead of
        the reference's five (training_data.py:188-210).
        """
        from gym2048_tpu_torch import native

        parsed = native.csv_read(filename) if native.available() else None
        self._pending.clear()
        if parsed is not None:
            boards, actions, rewards, next_boards, dones = parsed
            self._x = boards.astype(int)
            self._y_digit = actions.astype(int).reshape(-1, 1)
            self._reward = rewards.astype(float).reshape(-1, 1)
            self._next_x = next_boards.astype(int)
            self._done = dones.reshape(-1, 1)
        else:
            raw = np.loadtxt(
                filename, dtype=float, delimiter=",", skiprows=1, ndmin=2,
                usecols=tuple(range(35)),
            )
            self._x = raw[:, 0:16].astype(int).reshape(-1, 4, 4)
            self._y_digit = raw[:, 16].astype(int).reshape(-1, 1)
            self._reward = raw[:, 17].astype(float).reshape(-1, 1)
            self._next_x = raw[:, 18:34].astype(int).reshape(-1, 4, 4)
            self._done = raw[:, 34].astype(bool).reshape(-1, 1)
        self._check_lengths()

    def export_csv(self, filename, add_returns: bool = False) -> None:
        """Save in the reference's exact format (training_data.py:227-248).

        Native C++ writer when available; np.savetxt fallback produces
        byte-identical output.
        """
        from gym2048_tpu_torch import native

        items = self.size()
        header = self.construct_header(add_returns)
        returns = self.get_discounted_return() if add_returns else None
        if native.available():
            native.csv_write(
                str(filename), ",".join(header), self._x, self._y_digit,
                self._reward, self._next_x, self._done,
                returns=returns,
            )
            return
        flat = np.concatenate(
            (
                self._x.reshape(items, 16),
                self._y_digit,
                self._reward,
                self._next_x.reshape(items, 16),
                self._done,
            ),
            axis=1,
        )
        if add_returns:
            flat = np.concatenate((flat, returns), axis=1)
        fformat = "%d," * 17 + "%f," + "%d," * 16 + "%i"
        if add_returns:
            fformat += ",%f"
        np.savetxt(
            filename, flat, comments="", fmt=fformat,
            header=",".join(header),
        )

    def dump(self) -> None:
        self._flush()
        print(self._x)
        print(self._y_digit)
        print(self._reward)
        print(self._next_x)
        print(self._done)

    # --------------------------------------------------- device-side bridge
    def get_x_exponents(self) -> np.ndarray:
        """Boards as int8 log2 exponents — the device representation."""
        v = np.maximum(self.get_x().astype(np.int64), 1)
        return np.round(np.log2(np.maximum(v, 1))).astype(np.int8) * (
            self.get_x() > 0
        )

    @classmethod
    def from_rollout(
        cls, boards_exp, actions, rewards, next_boards_exp, dones
    ) -> "TrainingData":
        """Build from device rollout arrays (exponent boards)."""
        out = cls()
        b = np.asarray(boards_exp, dtype=np.int64)
        nb = np.asarray(next_boards_exp, dtype=np.int64)
        out._x = np.where(b > 0, 1 << b, 0).astype(int)
        out._next_x = np.where(nb > 0, 1 << nb, 0).astype(int)
        out._y_digit = np.asarray(actions, dtype=int).reshape(-1, 1)
        out._reward = np.asarray(rewards, dtype=float).reshape(-1, 1)
        out._done = np.asarray(dones, dtype=bool).reshape(-1, 1)
        out._check_lengths()
        return out


# Reference-compatible alias (the reference exposes class ``training_data``).
training_data = TrainingData
