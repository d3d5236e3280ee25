"""``predict_batch_ms.serve``: the mean host span, in the harness's own
wrapper, of the ``Predictor.predict_batch`` calls the server made that
ended in the window."""


def read(job, outcome):
    ms = outcome.layer["predict_batch_ms"]
    return sum(ms) / len(ms) if ms else None
