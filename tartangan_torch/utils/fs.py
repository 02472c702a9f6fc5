"""Transparent local-or-S3 filesystem helpers.

Parity: the reference uses ``smart_open`` + boto3 everywhere for file IO
(reference tartangan/utils/fs.py:1-46 and scattered ``smart_open.open`` call
sites). We implement the same surface without a hard dependency: local paths
go through builtin ``open``; ``s3://`` URIs go through boto3 when it is
importable, and raise a clear error otherwise.
"""
from __future__ import annotations

import io
import os
import re
from contextlib import contextmanager

_S3_RE = re.compile(r"s3:\/\/(.+?)\/(.+)")


def is_s3_path(path: str) -> bool:
    return str(path).startswith("s3://")


def _s3():
    try:
        import boto3  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover - exercised only without boto3
        raise RuntimeError(
            "s3:// paths require boto3, which is not installed"
        ) from e
    return boto3.client("s3")


def _split_s3(path: str):
    m = _S3_RE.match(path)
    if not m:
        raise ValueError(f"malformed s3 path: {path}")
    return m.groups()


@contextmanager
def smart_open(path, mode="r"):
    """Open a local file or an s3:// URI (reference smart_open.open surface)."""
    path = str(path)
    if not is_s3_path(path):
        parent = os.path.dirname(path)
        if parent and any(w in mode for w in "wa"):
            os.makedirs(parent, exist_ok=True)
        with open(path, mode) as f:
            yield f
        return

    bucket, key = _split_s3(path)
    client = _s3()
    binary = "b" in mode
    if "r" in mode:
        raw = client.get_object(Bucket=bucket, Key=key)["Body"].read()
        buf = io.BytesIO(raw) if binary else io.StringIO(raw.decode("utf-8"))
        yield buf
    elif "w" in mode:
        buf = io.BytesIO() if binary else io.StringIO()
        yield buf
        data = buf.getvalue()
        if not binary:
            data = data.encode("utf-8")
        client.put_object(Bucket=bucket, Key=key, Body=data)
    else:
        raise ValueError(f"unsupported mode for s3: {mode}")


def maybe_makedirs(path, exist_ok=True):
    """mkdir -p unless the path lives on S3 (reference utils/fs.py:11-15)."""
    if is_s3_path(path):
        return
    os.makedirs(path, exist_ok=exist_ok)


def smart_ls(path):
    """List a local directory or the common prefixes under an S3 prefix
    (reference utils/fs.py:18-46)."""
    if not is_s3_path(path):
        if os.path.exists(path):
            return os.listdir(path)
        return []

    bucket, prefix = _split_s3(path)
    if not prefix.endswith("/"):
        prefix += "/"
    client = _s3()
    results = []
    paginator = client.get_paginator("list_objects")
    for resp in paginator.paginate(Bucket=bucket, Prefix=prefix, Delimiter="/"):
        if "CommonPrefixes" not in resp:
            break
        for common_prefix in resp["CommonPrefixes"]:
            dirname = common_prefix["Prefix"][len(prefix):].rstrip("/")
            results.append(dirname)
    return results


def list_files_recursive(root, extensions):
    """Recursive file scan filtered by extension
    (reference image_bytes_dataset.py:52-61)."""
    all_files = []
    for (path, _dirs, files) in os.walk(root):
        for name in files:
            if os.path.splitext(name)[1].lower() in extensions:
                all_files.append(os.path.join(path, name))
    return sorted(all_files)
