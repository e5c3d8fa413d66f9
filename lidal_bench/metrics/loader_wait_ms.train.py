"""Mean host wait per window step for the next batch from the port's
``FrameBatchLoader`` (the harness's proxy times each fetch ``run_train``
makes), in ms."""


def read(rec):
    waits = rec.get("waits") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
