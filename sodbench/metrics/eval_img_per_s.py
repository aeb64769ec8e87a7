"""eval_img_per_s: images scored by the Evaluator calls of the window, over
its length (its end is the end of the last call)."""


def read(name, run):
    c = run.counters
    return c["images"] / c["window_s"] if c.get("kind") == "eval" else None
