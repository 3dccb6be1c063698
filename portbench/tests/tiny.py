"""Tiny cells for the CPU tests: the shipped cells' files with sizes a
test run holds (the program runs its plain paths on the CPU)."""

from __future__ import annotations

import copy

from portbench.lib.harness import load_cell

TINY = {
    "cub_gan_512": dict(dataset_size=8, model=dict(texture_resolution=128,
                                                   num_discriminators=2),
                        evaluation_res=32),
    "cub_recon": dict(dataset_size=8, model=dict(image_resolution=64,
                                                 texture_resolution=64)),
}
TINY_TRAFFIC = dict(batch_size=2, items=8, warmup_steps=1, warmup_calls=1,
                    check_batches=2, check_rows=2, feed_threads=2)


def tiny_cell(name: str):
    """(traffic, configuration, entry) of cell ``name`` at a tiny size."""
    traffic, config, entry = load_cell(name)
    config = copy.deepcopy(config)
    for k, v in TINY[traffic["config"]].items():
        if isinstance(v, dict):
            config[k].update(v)
        else:
            config[k] = v
    traffic = dict(traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                               if k in traffic})
    return traffic, config, entry
