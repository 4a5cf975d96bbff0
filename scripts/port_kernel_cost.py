"""The cost each kernel leaves on the main paths, from a `chip_smoke.py`
run: launches x (ms - bound), each launch at its own shape.

    python3 scripts/port_kernel_cost.py SMOKE_STDOUT

Reads the `kernels` JSON line of a `chip_smoke.py` run's standard output.
An LK update runs the chain kernel 6 times at N = 169, 3 times at 625
and once at 2500 (`chip_smoke.SCHEDULE`, `MAX_ITERS`), so an S = 8 mode's
launches are charged 6/10 at its N = 169 row, 3/10 at 625 and 1/10 at
2500 (`by_n`); the other state sizes have only their N = 2500 row, which
every launch of theirs is charged. The grid flow's launches are charged
at the rklt levels' rows half and half, but for Median Flow's, at its
update's row (6 launches). K4b and K6 run on no tracker path: their
launches are the kernel phase's, and their cost here is 0. Prints one
line per kernel, then one JSON object {name: cost in ms}, in the order of
the cost.
"""
import json
import sys

# share of an LK update's chain launches at each N (6 + 3 + 1 iterations)
N_SHARE = {"169": 0.6, "625": 0.3, "2500": 0.1}


def _kernels(path):
    for line in open(path):
        if line.startswith('{"kernels"'):
            return json.loads(line)["kernels"]
    raise SystemExit(f"{path}: no kernels line")


def cost(entry):
    """launches x (ms - bound) of one kernels-line entry, in ms."""
    if "(K4b" in entry["name"] or "(K6)" in entry["name"]:
        return 0.0
    n = entry["launches"]
    if "by_n" in entry and set(N_SHARE) <= set(entry["by_n"]):
        return sum(n * share * (entry["by_n"][k]["ms"]
                                - entry["by_n"][k]["bound_ms"])
                   for k, share in N_SHARE.items())
    levels = entry.get("by_level")
    if levels:
        mf = entry.get("launches_by_fleet", {}).get("mf", 0)
        rest = n - mf
        out = sum(rest / 2 * (levels[k]["ms"] - levels[k]["bound_ms"])
                  for k in ("0", "1"))
        if mf:
            out += mf / 6 * (levels["mf"]["ms"] - levels["mf"]["bound_ms"])
        return out
    return n * (entry["ms"] - entry["bound_ms"])


def main(path: str) -> int:
    costs = {e["name"]: cost(e) for e in _kernels(path)}
    for name, c in sorted(costs.items(), key=lambda kv: -kv[1]):
        print(f"{c:9.2f} ms  {name}")
    print(json.dumps(dict(sorted(costs.items(), key=lambda kv: -kv[1]))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
