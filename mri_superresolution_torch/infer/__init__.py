"""Serving: the engine (``engine.py``), the daemon (``server.py``) and
portable artifacts (``export.py``). Names are imported on first use, so
that loading an artifact never imports the engine or the model zoo."""

_NAMES = {"InferenceEngine": "engine", "load_engine": "engine",
          "preprocess_image_array": "engine", "DynamicBatcher": "server",
          "QueueFullError": "server", "serve_http": "server",
          "ServingArtifact": "export", "export_artifact": "export",
          "load_artifact": "export"}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                   name)
