"""driver layer (`rt3d_torch.runtime.driver`): mean host ms a frame in the
driver's own `Frame Retrieval` span, the wait for the uploader's pinned
copy, over the window's frames."""


def read(record):
    v = record["retrieval_s"]
    return 1e3 * sum(v) / len(v) if v else None
