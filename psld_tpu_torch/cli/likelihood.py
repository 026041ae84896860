"""Dataset NLL (bits/dim) through the probability-flow ODE.

    python -m psld_tpu_torch.cli.likelihood +dataset=cifar10/cifar10_psld \\
        dataset.diffusion.data.root=... \\
        dataset.diffusion.evaluation.chkpt_path=ckpt.pt \\
        [+dataset.diffusion.evaluation.likelihood.n_steps=100] \\
        [+dataset.diffusion.evaluation.likelihood.solver=rk4] \\
        [+dataset.diffusion.evaluation.likelihood.n_probes=1]

Prints ``nll: <x> bits/dim``: the VP-SDE's NLL, or the variational upper
bound of the PSLD state. Runs on ``cuda`` unless
``+dataset.diffusion.evaluation.device=cpu``.
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None):
    """Evaluate as the config says; returns (bits/dim, per-batch stats)
    of ``eval.likelihood.evaluate_nll``."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.eval.likelihood import evaluate_nll

    bpd, batches = evaluate_nll(cfg.dataset.diffusion)
    print(f"nll: {bpd:.4f} bits/dim")
    return bpd, batches


if __name__ == "__main__":
    main()
