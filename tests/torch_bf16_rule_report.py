"""How far apart bf16 train steps that differ only in rounding lie, by the rule of
``tests/test_torch_train_bf16.py``.

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_rule_report

For TD4-PSP18 and TD2-PSP50 at the CPU test size (``tests/
test_torch_train_bf16_k5.py:bf16_runs``: the port's bf16 step with K5 and with
cuDNN's convs, JAX's bf16 step with its Pallas dilated conv and with its
default convs, and JAX's f32 step), prints the largest share of that rule's
gradient limit, and its gradient, that each pair takes: a share of 1 is the
limit, twice the second step's distance from JAX's f32 step plus 1e-3 of its
max|grad|.
"""

import jax

jax.config.update("jax_platforms", "cpu")

from tests.test_torch_train_bf16_k5 import ARCHS, bf16_runs, rule_share  # noqa: E402

PAIRS = (("port_bf16", "jax_bf16", "the port's K5 step vs JAX's Pallas step"),
         ("port_bf16_cudnn", "jax_bf16", "the port's cuDNN step vs JAX's Pallas step"),
         ("port_bf16_cudnn", "jax_bf16_default", "the port's cuDNN step vs JAX's default step"),
         ("jax_bf16_default", "jax_bf16", "JAX's default step vs JAX's Pallas step"))


def main() -> None:
    for arch in ARCHS:
        runs = bf16_runs(arch)
        for got, want, what in PAIRS:
            share, name = rule_share(runs[got][1], runs[want][1], runs["jax_f32"][1])
            print(f"{arch}: {what}: {share:.3f} of the limit ({name})", flush=True)


if __name__ == "__main__":
    main()
