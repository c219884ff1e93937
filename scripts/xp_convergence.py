"""Why the plain Xpress parse (``tpucomp_torch/kernels/csrc/xp_parse.cu``)
walks a skeleton instead of decoding speculative segments: a CPU model.

For 12 units of 64 KiB of ``benchmarks/corpus.py silesia_like`` (every 8th
unit of 8 MiB), encoded by the native C encoder, it runs the byte
machine's structure (mode, flag word, shared nibble) over each stream from
its start, and from a guess ("a fresh flag word, no stored nibble") at
every 1 KiB of the stream, and counts the bytes until the guessed path
meets the true one (the same structural state at the same byte), up to
8 KB.  It also counts each stream's tokens, matches and flag words: the
skeleton chain the kernel walks.  CPU counts, not device measurements.

    python3 scripts/xp_convergence.py
"""

from __future__ import annotations

import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS = 12
STRIDE = 8       # every 8th unit of 64 KiB
SEGMENT = 1024   # a guessed segment every SEGMENT bytes
LIMIT = 8192     # bytes a guess may take to meet the true path

# modes: flag word bytes 0-3, a token, a match's high byte, a nibble byte,
# a byte escape, u16 bytes 0-1, u32 bytes 0-3
F0, TOK, HI, NIB, ESC, U16, U32 = 0, 4, 5, 6, 7, 8, 10


def step(st, b):
    """One byte of the machine's structure: st = (mode, flags, nflags,
    nib_have, nib_val, lo, acc); returns the next state and whether the
    byte ended a token (a literal or a match) and was a match's."""
    mode, flags, nflags, have, nv, lo, acc = st
    end = False
    if mode < TOK:
        flags |= b << (8 * mode)
        mode, nflags = (TOK, 32) if mode == 3 else (mode + 1, nflags)
    elif mode == TOK:
        if flags >> 31:
            mode, lo = HI, b
        else:
            end = True
    elif mode == HI:
        if (lo & 7) < 7:
            end = True
        elif have:
            have = 0
            end = nv < 15
            mode = ESC if nv == 15 else mode
        else:
            mode = NIB
    elif mode == NIB:
        have, nv = 1, b >> 4
        end = (b & 15) < 15
        mode = ESC if not end else mode
    elif mode == ESC:
        end = b < 255
        mode = U16 if not end else mode
    elif mode == U16:
        mode, acc = U16 + 1, b
    elif mode == U16 + 1:
        end = (acc | b << 8) != 0
        mode = U32 if not end else mode
    elif U32 <= mode < U32 + 3:
        mode += 1
    else:
        end = True
    match = end and mode != TOK
    if end:
        flags = (flags << 1) & 0xFFFFFFFF
        nflags -= 1
        mode = F0 if nflags == 0 else TOK
        flags = 0 if nflags == 0 else flags
    return (mode, flags, nflags, have, nv, lo, acc), end, match


def live(st):
    """The fields of a state that decide the rest of the walk."""
    mode, flags, nflags, have, nv, lo, acc = st
    return (mode, flags, nflags, have, nv if have else 0,
            lo if mode in (HI, NIB, ESC) or mode >= U16 else 0,
            acc if mode == U16 + 1 else 0)


INIT = (F0, 0, 0, 0, 0, 0, 0)


def unit_counts(stream: bytes, olen: int):
    """(tokens, matches, flag words, [bytes each guess took to meet the
    true path, None past LIMIT]) of one unit stream."""
    states, st = [], INIT
    tokens = matches = words = 0
    for b in stream:
        states.append(live(st))
        words += st[0] == F0
        st, end, match = step(st, b)
        tokens += end
        matches += match
        if tokens >= olen:  # an upper bound on the decoded bytes: enough
            break
    meets = []
    for start in range(SEGMENT, len(states), SEGMENT):
        st, met = INIT, None
        for k in range(start, min(start + LIMIT, len(states))):
            if live(st) == states[k]:
                met = k - start
                break
            st = step(st, stream[k])[0]
        meets.append(met)
    return tokens, matches, words, meets


def main() -> None:
    sys.path.insert(0, ROOT)
    from benchmarks.corpus import silesia_like
    from chip_smoke import Native

    native = Native()
    unit = 1 << 16
    data = silesia_like(8 << 20)
    missed = total = 0
    for k in range(UNITS):
        u = data[k * STRIDE * unit:(k * STRIDE + 1) * unit]
        s = native.xpress_compress(u)
        tokens, matches, words, meets = unit_counts(s, len(u))
        met = [m for m in meets if m is not None]
        missed += len(meets) - len(met)
        total += len(meets)
        print(f"unit {k * STRIDE}: body {len(s)} bytes, {tokens} tokens, "
              f"{matches} matches, {words} flag words; {len(meets)} guesses, "
              f"median bytes to meet "
              f"{statistics.median(met) if met else 'none'}, "
              f"{len(meets) - len(met)} not within {LIMIT}")
    print(f"{missed} of {total} guesses did not meet the true path within "
          f"{LIMIT} bytes")


if __name__ == "__main__":
    main()
