"""Milliseconds per step that the training loop waited for its next batch
(``data/packed.py``'s loader behind ``parallel/prefetch.py``): the
harness's own span around each ``next()`` over the untraced stretch."""

LAYER = "engine, training data"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_img_per_s"
WORKLOADS = ("transformnet.train-b4",)


def read(layer, config, traffic):
    steps = layer.get("untraced_steps", 0)
    if not steps:
        return None
    return 1e3 * layer["data_wait_s"] / steps
