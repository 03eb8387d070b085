"""Serving: artifacts of the port's eval steps and an HTTP server for them
(counterpart of ``madtp_tpu/serve``).  See :mod:`.artifact` for the format
and :mod:`.server` for the wire protocol."""

from madtp_tpu_torch.serve.artifact import (  # noqa: F401
    MeshServingModel,
    ServingModel,
    follow,
    load_artifact,
    save_artifact,
)


def __getattr__(name):  # lazy: the artifact loader does not need http
    if name in ("ArtifactServer", "ServingClient"):
        from madtp_tpu_torch.serve import server

        return getattr(server, name)
    raise AttributeError(name)
