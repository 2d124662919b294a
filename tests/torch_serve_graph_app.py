"""Importable builder for the port's config-deploy graph scenario
(`tests/test_torch_serve_plane.py`): the two-stage graph of
`tests/serve_graph_app.py`, built on `ray_tpu_torch.serve`."""
from ray_tpu_torch import serve


@serve.deployment
class Cleaner:
    def __call__(self, text):
        return text.strip().lower()


@serve.deployment
class Decorator:
    def __init__(self, cleaner, suffix):
        self.cleaner = cleaner
        self.suffix = suffix

    def __call__(self, text):
        return self.cleaner.remote(text).result(timeout=30) + self.suffix


def build():
    return Decorator.bind(Cleaner.bind(), "?")
