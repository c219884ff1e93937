"""Compressed bytes over input bytes, in %, over the cell's pool of
inputs, each input counted once (by its first output)."""


def read(ctx):
    encoded, decoded = ctx.pool_bytes
    if ctx.direction != "write" or not decoded:
        return None
    return 100.0 * encoded / decoded
