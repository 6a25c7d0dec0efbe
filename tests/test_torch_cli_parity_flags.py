"""The port's train and test CLIs against the JAX package's, on the
CPU, from one initial state converted from JAX's
(``tests/_cli_parity.py``): with a set of non-default flags (``--norm
--pooling avg --droplast --os_rate 2 --weight_decay 1e-4``) and with
``--compute_dtype bfloat16 --exact_levels`` (JAX's train steps take its
fused exact walk, the port's; validations and the test CLI its padded
scan, which the port's evaluations round as); and from ``--seed`` alone,
each package drawing its own weights, for one epoch with the default
flags and with ``--unet --seed 3``."""

from _cli_parity import (cli_runs_fixture, corpus_data,  # noqa: F401
                         test_test_cli_writes_jax_predictions,
                         test_train_cli_prints_jax_values,
                         test_train_cli_saves_jax_config, unet_data)

import _torch_threads  # noqa: F401  (one torch thread a worker)

cli_runs = cli_runs_fixture(['flags', 'bf16', 'seeded', 'seeded_unet'])
