"""train_rays_per_s (rays/s): the rays of every step the window's jobs ran
(iterations 0 to iters_run, a batch each), over the window's seconds."""


def read(ctx):
    rays = sum((j["iters_run"] + 1) * ctx["batch"] for j in ctx["jobs"])
    return rays / ctx["window_s"]
