"""The port's train and test CLIs against the JAX package's, on the
CPU, from one initial state converted from JAX's
(``tests/_cli_parity.py``): for the classification task
(``--task cls --nlabels 2``) and the U-Net (``--unet``, on a 3-channel
corpus whose raster side is 2 x ``--map_size``)."""

from _cli_parity import (cli_runs_fixture, corpus_data,  # noqa: F401
                         test_test_cli_writes_jax_predictions,
                         test_train_cli_prints_jax_values,
                         test_train_cli_saves_jax_config, unet_data)

cli_runs = cli_runs_fixture(['cls', 'unet'])
