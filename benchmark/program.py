"""The system under test, as the benchmark builds it: the port's config
composed from a configuration file, its score network with the
benchmark's seeded weights, and the entries the cells drive. Everything
here calls the port's own set-up functions; nothing of the port's is
copied."""

from __future__ import annotations

import torch


def _yaml_value(v) -> str:
    """``v`` as the port's config parser (``yaml.safe_load``) reads it."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_yaml_value(x) for x in v) + "]"
    return str(v)


def _same(a, b) -> bool:
    if isinstance(b, (list, tuple)):
        return isinstance(a, (list, tuple)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(b, bool) or isinstance(a, bool):
        return bool(a) == bool(b) and type(a) is type(b)
    if isinstance(b, (int, float)):
        try:
            return float(a) == float(b)
        except (TypeError, ValueError):
            return False
    return str(a) == str(b)


# the configuration file's blocks and where they sit in the port's tree
_BLOCKS = {"model": "model.score_fn", "sde": "model.sde"}


def port_config(cfg: dict, device: str):
    """The port's ``dataset.diffusion`` config of configuration file
    ``cfg``: its ``port_config`` YAML with every number of ``model`` and
    ``sde`` set as the file states (checked after composing), bfloat16
    compute and ``gn_bf16`` as ``compute`` states, on ``device``."""
    import psld_tpu_torch
    from psld_tpu_torch.config import compose

    psld_tpu_torch.import_modules_into_registry()
    pre = "dataset.diffusion."
    args = ["+dataset=" + cfg["port_config"], pre + "data.root=/unused"]
    base = compose(list(args)).dataset.diffusion
    wanted = {}
    for block, path in _BLOCKS.items():
        node = base
        for part in path.split("."):
            node = node[part]
        for k, v in cfg[block].items():
            wanted[f"{path}.{k}"] = v
            if k not in node.to_dict():
                args.append(f"+{pre}{path}.{k}={_yaml_value(v)}")
            elif not _same(node.get(k), v):
                args.append(f"{pre}{path}.{k}={_yaml_value(v)}")
    tr = cfg["training"]
    for k in ("train_eps", "ema_decay"):
        wanted[f"training.{k}"] = tr[k]
        args.append(f"{pre}training.{k}={_yaml_value(tr[k])}")
    for k, v in tr["optimizer"].items():
        wanted[f"training.optimizer.{k}"] = v
        args.append(f"{pre}training.optimizer.{k}={_yaml_value(v)}")
    wanted["data.image_size"] = cfg["image_size"]
    args.append(f"{pre}data.image_size={cfg['image_size']}")
    bf16 = bool(cfg["compute"]["bf16"])
    args += [f"+{pre}model.score_fn.gn_bf16="
             + _yaml_value(bool(cfg["compute"]["gn_bf16"])),
             f"+{pre}training.bf16={_yaml_value(bf16)}",
             f"+{pre}evaluation.bf16={_yaml_value(bf16)}",
             f"+{pre}training.device={device}",
             f"+{pre}evaluation.device={device}"]
    out = compose(args).dataset.diffusion
    for key, v in wanted.items():
        node = out
        for part in key.split("."):
            node = node[part]
        if not _same(node, v):
            raise ValueError(f"the port's config has {key}={node!r}, the "
                             f"configuration file {v!r}")
    return out


def score_net(pcfg, weights: dict, device):
    """The port's score network of ``pcfg``, built on the ``meta`` device
    and given ``weights`` (float32, on ``device``) in place of its own
    initialisation."""
    from psld_tpu_torch.eval.generate import build_score_model

    with torch.device("meta"):
        net = build_score_model(pcfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return net


def em_sampler(pcfg, weights: dict, device):
    """``(sde, sampler)`` as ``cli.sample`` sets them up
    (``eval.generate.build_unguided`` on a preloaded network: the
    configured sampler on ``make_score_fn(net, bf16=...)``)."""
    from psld_tpu_torch.eval.generate import build_unguided

    net = score_net(pcfg, weights, device)
    sde, sampler, _, _ = build_unguided(pcfg, preloaded=net)
    return sde, sampler


def train_step(pcfg, weights: dict, device):
    """``(step, state, optimizer)`` as ``cli.train_sde`` sets them up:
    ``train.steps.make_train_step`` on ``train.state.init_state`` of the
    network's parameters."""
    from psld_tpu_torch.eval.generate import build_sde
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import make_train_step

    net = score_net(pcfg, weights, device)
    sde = build_sde(pcfg)
    criterion = get_module("losses", pcfg.training.loss.name)(pcfg, sde)
    step, optimizer = make_train_step(net, sde, criterion, pcfg)
    state = init_state(dict(net.named_parameters()), optimizer)
    return step, state, optimizer
