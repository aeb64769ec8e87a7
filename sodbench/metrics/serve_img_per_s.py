"""serve_img_per_s: requests that the callers saw completed inside the
window, over its length."""


def read(name, run):
    c = run.counters
    return c["requests"] / c["window_s"] if c.get("kind") == "serve" else None
