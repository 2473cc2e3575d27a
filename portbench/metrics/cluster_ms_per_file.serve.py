"""cluster_ms_per_file.serve: host milliseconds inside the pipeline's
clustering (the benchmark's wrapper around `DiarizationPipeline.clustering`)
per file, over the files of the untraced part of the window."""


def read(ctx):
    if not ctx or not ctx.get("files") or not ctx.get("cluster_ms"):
        return None
    return sum(ctx["cluster_ms"]) / ctx["files"]
