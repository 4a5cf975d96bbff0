"""Layered cfg-file + CLI parameter system (port of
`mtf_tpu/utils/config.py`).

Re-designs the reference config layer
(`Config/parameters.h:4195-4281` readParams /
parseArgumentPairs): the same file format — whitespace-separated
``key value`` lines, ``#`` prefix disables a line, comma-separated vector
values — and the same layered load order with CLI-pairs-last-wins. The
~900 mutable globals become one plain dict consumed by explicit dataclass
constructors in the factory (the mutable-global side channel is
deliberately dropped, SURVEY.md §5.6).
"""
from __future__ import annotations

import os
from typing import Any, Iterable

# reference load order (parameters.h:4216-4273)
DEFAULT_CFG_FILES = ["mtf.cfg", "modules.cfg", "feat.cfg", "examples.cfg",
                     "sigma.cfg", "thirdparty.cfg"]


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if "," in raw:
        return [_parse_value(v) for v in raw.split(",") if v.strip()]
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def parse_cfg_text(text: str) -> dict:
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) == 1:
            continue
        key, value = parts
        if ":" in key:
            # id-indexed preset line `NN:param value` (sigma.cfg format,
            # Config/sigma.cfg:1-25; selected via *_ids lists)
            idx, pkey = key.split(":", 1)
            try:
                presets = out.setdefault("_presets", {}).setdefault(pkey, {})
                presets[int(idx)] = _parse_value(value)
                continue
            except ValueError:
                pass
        out[key] = _parse_value(value)
    return out


def resolve_sigma_presets(cfg: dict, ids) -> list:
    """Map preset id list -> sigma vectors (mtf.h:268-309 sigma registry)."""
    presets = cfg.get("_presets", {}).get("ssm_sigma", {})
    if isinstance(ids, (int, float)):
        ids = [int(ids)]
    out = []
    for i in ids:
        if int(i) not in presets:
            raise KeyError(f"ssm_sigma preset {i} not in sigma.cfg")
        v = presets[int(i)]
        out.append(v if isinstance(v, list) else [v])
    return out


def read_multi_cfg(path_or_text: str) -> list[dict]:
    """Parse multi.cfg: per-tracker parameter blocks separated by blank
    lines (Config/multi.cfg; consumed by readTrackerParams for cascade/
    parallel/multi-tracker runs, parameters.h:4029)."""
    text = path_or_text
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    blocks, cur = [], []
    for line in text.splitlines():
        if line.strip() == "":
            if cur:
                blocks.append(parse_cfg_text("\n".join(cur)))
                cur = []
            continue
        cur.append(line)
    if cur:
        blocks.append(parse_cfg_text("\n".join(cur)))
    return [post_process(b) for b in blocks if b]


def read_cfg_file(path: str) -> dict:
    with open(path) as f:
        return parse_cfg_text(f.read())


def parse_arg_pairs(args: Iterable[str]) -> dict:
    """CLI `key value` pairs (parseArgumentPairs, parameters.h:4064)."""
    args = [a for a in args]
    out = {}
    i = 0
    while i < len(args):
        key = args[i].lstrip("-")
        if i + 1 >= len(args):
            raise ValueError(f"dangling argument {key!r}")
        out[key] = _parse_value(args[i + 1])
        i += 2
    return out


def read_params(config_dir: str | None = None,
                cli_args: Iterable[str] = ()) -> dict:
    """Layered load: cfg files in reference order, then CLI pairs
    (last wins — readParams, parameters.h:4195-4281)."""
    cfg: dict = {}
    if config_dir:
        for name in DEFAULT_CFG_FILES:
            path = os.path.join(config_dir, name)
            if os.path.exists(path):
                cfg.update(read_cfg_file(path))
    cfg.update(parse_arg_pairs(cli_args))
    return post_process(cfg)


def post_process(cfg: dict) -> dict:
    """Dependency resolution pass (postProcessParams analog,
    parameters.h:4125): normalize reference aliases onto factory names."""
    out = dict(cfg)
    # reference key names -> factory names
    alias = {
        "mtf_sm": "sm", "mtf_am": "am", "mtf_ssm": "ssm", "mtf_ilm": "ilm",
        "mtf_res": "mtf_res",
    }
    for src, dst in alias.items():
        if src in out and dst not in out:
            out[dst] = out[src]
    if "mtf_res" in out:
        out.setdefault("resx", out["mtf_res"])
        out.setdefault("resy", out["mtf_res"])
    return out
