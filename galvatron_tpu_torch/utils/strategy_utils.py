"""Strategy list helpers (reference: galvatron/utils/strategy_utils.py,
config_utils.py:8-12).

A "search strategy" is the list form used by the search engine:
``[pp, tp, dp, {'fsdp':0/1, 'sp':0/1, 'cp':int, 'ckpt':0/1, 'tp':0/1(consec)}]``.
"""


def str2array(s):
    return list(map(int, str(s).split(",")))


def array2str(a):
    return ",".join(map(str, a))


def form_strategy(strategy):
    """Pretty-print one search strategy, e.g. ``2-4-1-sp-fsdp-ckpt``."""
    pp, tp, dp = strategy[0], strategy[1], strategy[2]
    info = strategy[3] if len(strategy) > 3 else {}
    tag = "%d-%d-%d" % (pp, tp, dp)
    if info.get("cp", 1) > 1:
        tag += "-cp%d" % info["cp"]
    if info.get("sp", 0):
        tag += "-sp"
    elif tp > 1 and not info.get("tp", 1):
        tag += "-nonconsec"
    if info.get("fsdp", 0):
        tag += "-fsdp"
    if info.get("cpt", info.get("ckpt", 0)):
        tag += "-ckpt"
        # remat-policy axis: a non-default policy changes both the memory
        # and the time cost, so it is part of the cache identity too
        if info.get("rp", "full") != "full":
            tag += "[%s]" % info["rp"]
    # comm-precision axis (quantized collectives): part of the identity —
    # the cost-model caches key on this string
    if info.get("gcd", "none") != "none":
        tag += "-g%s" % info["gcd"]
    if info.get("pcd", "none") != "none":
        tag += "-p%s" % info["pcd"]
    return tag


def print_strategies(strategy_list, stream=None):
    import sys

    stream = stream or sys.stdout
    if strategy_list is None:
        print("None", file=stream)
        return
    print(", ".join(form_strategy(s) for s in strategy_list), file=stream)
