"""train_img_per_s: training images over the whole window, whose end is a
synchronize after the last step."""


def read(name, run):
    c = run.counters
    return c["images"] / c["window_s"] if c.get("kind") == "train" else None
