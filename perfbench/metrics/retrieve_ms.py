"""Milliseconds per pass of retrieval: the global descriptor's
``describe_batch`` and the retriever's ``get_image_pairs``, each in a
synchronized span."""


def read(ctx):
    spans = ctx["spans"].seconds
    if not spans.get("retrieve") or not ctx["passes"]:
        return None
    return 1e3 * (sum(spans.get("global_descriptor", [])) + sum(spans["retrieve"])) / ctx["passes"]
