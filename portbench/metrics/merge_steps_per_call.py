"""Per traced call, the steps of the Huffman code-length merge and the
rounds of its 15-bit repair (``huffman.merge_steps`` and
``huffman.repair_rounds``): each a run of small ops the host issues one
after another."""

from portbench import spans


def read(ctx):
    s = spans.per_call(ctx)
    if s is None:
        return None
    n = s["counters"]
    if "huffman.merge_steps" not in n:
        return None
    return (n["huffman.merge_steps"] + n.get("huffman.repair_rounds", 0)) \
        / s["calls"]
