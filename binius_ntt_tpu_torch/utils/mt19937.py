"""Exact std::mt19937 (32-bit Mersenne Twister) reimplementation.

The reference repo seeds ``std::mt19937`` and consumes the raw uint32 stream
to build golden-hash test inputs (reference: src/ulvt/ntt/tests/test_ntt.cu:128,
:159, :192).  Reproducing those golden MD5 hashes bit-exactly therefore
requires a word-for-word identical generator on the host side.

This is the standard MT19937 algorithm (Matsumoto & Nishimura), parameterised
exactly as libstdc++/libc++ parameterise ``std::mt19937``:
  w=32, n=624, m=397, r=31, a=0x9908B0DF, u=11, d=0xFFFFFFFF,
  s=7, b=0x9D2C5680, t=15, c=0xEFC60000, l=18, f=1812433253.

The twist is vectorised with numpy so generating 2^30 words is fast.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)


class MT19937:
    """Bit-exact std::mt19937 with block (vectorised) generation."""

    def __init__(self, seed: int):
        state = np.empty(_N, dtype=np.uint32)
        state[0] = np.uint32(seed & 0xFFFFFFFF)
        # init_genrand: state[i] = f * (state[i-1] ^ (state[i-1] >> 30)) + i
        s = int(state[0])
        for i in range(1, _N):
            s = (1812433253 * (s ^ (s >> 30)) + i) & 0xFFFFFFFF
            state[i] = s
        self._state = state
        self._pending = np.empty(0, dtype=np.uint32)

    def _next_block(self) -> np.ndarray:
        """Twist, then return all 624 tempered outputs of the new state.

        The canonical twist is in-place: for i >= n-m it reads state words
        that were already rewritten earlier in the same pass, so the
        vectorised version runs in two passes plus the final wrap element.
        """
        old = self._state
        new = np.empty_like(old)

        def _twisted(cur, nxt, plus_m):
            y = (cur & _UPPER_MASK) | (nxt & _LOWER_MASK)
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
            return plus_m ^ (y >> np.uint32(1)) ^ mag

        # The in-place recurrence new[i] = f(old[i], old[i+1], new[i-(n-m)])
        # has a dependency chain of stride n-m, so process in chunks of n-m.
        step = _N - _M
        for start in range(0, _N - 1, step):
            end = min(start + step, _N - 1)
            plus_m = old[start + _M :] if start == 0 else new[start - step : end - step]
            new[start:end] = _twisted(old[start:end], old[start + 1 : end + 1], plus_m)
        # final element wraps: next is new[0], plus_m is new[m-1]
        new[_N - 1 : _N] = _twisted(old[_N - 1 :], new[0:1], new[_M - 1 : _M])
        self._state = new

        y = self._state.copy()
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        return y

    def draw(self, count: int) -> np.ndarray:
        """Return the next `count` uint32 outputs as a numpy array."""
        chunks = []
        need = count
        if self._pending.size:
            take = min(need, self._pending.size)
            chunks.append(self._pending[:take])
            self._pending = self._pending[take:]
            need -= take
        while need > 0:
            block = self._next_block()
            take = min(need, _N)
            chunks.append(block[:take])
            if take < _N:
                self._pending = block[take:]
            need -= take
        if len(chunks) == 1:
            return chunks[0].copy()
        return np.concatenate(chunks)

    def __call__(self) -> int:
        return int(self.draw(1)[0])


def mt19937_stream(seed: int, count: int) -> np.ndarray:
    """The first `count` outputs of std::mt19937(seed), as uint32."""
    return MT19937(seed).draw(count)
