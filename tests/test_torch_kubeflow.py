"""The Kubeflow glue and the scraper of the port, on local fixtures only.

- A fake ``kubeflow.metadata`` module in ``sys.modules`` records the
  ``Store``, ``Workspace``, ``Execution``, ``DataSet`` and ``Model`` the
  apps make; ``assign_dataset_metadata`` registers a local file and
  ``download_dataset`` copies it back by name.
- The trainer's Kubeflow checkpoint component (``--metrics-collector
  kubeflow --kubeflow-metadata``) logs the final checkpoint as a Model and
  a later run with the same run id resumes from the Model's URI.
- The scraper against an ``http.server`` on 127.0.0.1: one PNG, one 404
  and one page that is not an image, with its state and error files saved
  and resumed. Nothing leaves the machine.
"""
import json
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tartangan_torch import scraper
from tartangan_torch.kubeflow import assign_dataset_metadata, download_dataset
from tartangan_torch.train.cnn import CNNTrainer
from tartangan_torch.utils import msgpack


def _fake_metadata():
    made = []
    artifacts = {}

    class Store:
        def __init__(self, grpc_host, grpc_port):
            made.append(("Store", grpc_host, grpc_port))

    class Workspace:
        def __init__(self, store, name):
            made.append(("Workspace", name))
            self.name = name

        def list(self, type_name):
            return [dict(a) for a in artifacts.get((self.name, type_name),
                                                   [])]

    class _Artifact:
        def __init__(self, name, uri, version):
            made.append((type(self).__name__, name, uri, version))
            self.fields = {"name": name, "uri": uri, "version": version}

    class DataSet(_Artifact):
        ARTIFACT_TYPE_NAME = "kubeflow.org/alpha/data_set"

    class Model(_Artifact):
        ARTIFACT_TYPE_NAME = "kubeflow.org/alpha/model"

    class Execution:
        def __init__(self, name, workspace):
            made.append(("Execution", name, workspace.name))
            self.workspace = workspace

        def log_output(self, artifact):
            key = (self.workspace.name, artifact.ARTIFACT_TYPE_NAME)
            artifacts.setdefault(key, []).append(artifact.fields)

    metadata = types.SimpleNamespace(Store=Store, Workspace=Workspace,
                                     Execution=Execution, DataSet=DataSet,
                                     Model=Model)
    return metadata, made


@pytest.fixture()
def fake_kubeflow(monkeypatch):
    metadata, made = _fake_metadata()
    package = types.ModuleType("kubeflow")
    module = types.ModuleType("kubeflow.metadata")
    module.metadata = metadata
    package.metadata = module
    monkeypatch.setitem(sys.modules, "kubeflow", package)
    monkeypatch.setitem(sys.modules, "kubeflow.metadata", module)
    monkeypatch.setenv("METADATA_STORE_HOST", "localhost")
    monkeypatch.setenv("METADATA_STORE_PORT", "9999")
    return made


def test_missing_kubeflow_raises_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules, "kubeflow", None)
    with pytest.raises(RuntimeError, match="kubeflow-metadata"):
        assign_dataset_metadata.main(["d", "/nowhere"])


def test_assign_and_download_dataset(fake_kubeflow, tmp_path):
    src = tmp_path / "data.npz"
    src.write_bytes(b"dataset bytes")
    assign_dataset_metadata.main(["tartans", str(src), "--version", "3",
                                  "--workspace", "ws"])
    assert ("Store", "localhost", 9999) in fake_kubeflow
    assert ("Execution", "assign-dataset-metadata", "ws") in fake_kubeflow
    assert ("DataSet", "tartans", str(src), "3") in fake_kubeflow
    out = tmp_path / "copy.npz"
    download_dataset.main(["tartans", str(out), "--workspace", "ws"])
    assert out.read_bytes() == b"dataset bytes"


def _argv(archive, out, *extra):
    return [archive, "--config", "8", "--batch-size", "8", "--epochs", "1",
            "--output", str(out), "--run-id", "kf", "--gen-freq", "100",
            "--checkpoint-freq", "100", "--quiet-logs", "--device", "cpu",
            "--metrics-collector", "kubeflow", "--metrics-path",
            str(out / "metrics.json"), "--kubeflow-metadata", *extra]


def test_checkpoint_component_logs_and_resumes(fake_kubeflow, tiny_archive,
                                               tmp_path):
    from tartangan_torch.train.components.kubeflow_model_checkpoint import (
        KubeflowModelCheckpointComponent,
    )
    first = CNNTrainer.create_from_cli(_argv(tiny_archive, tmp_path))
    assert any(isinstance(c, KubeflowModelCheckpointComponent)
               for c in first.components.components)
    first.train()
    assert first.steps == 3
    root = f"{tmp_path}/kf/checkpoints/3"
    assert ("Model", "kf", root, "0") in fake_kubeflow
    assert ("Execution", "train", "tartangan") in fake_kubeflow

    again = CNNTrainer.create_from_cli(_argv(tiny_archive, tmp_path))
    again.train()  # resumes at epoch 2 of 1: no step
    assert again.steps == 3
    saved = {name: msgpack.loads(open(f"{root}/{name}.msgpack", "rb").read())
             for name in ("g", "d", "opt_g")}
    mine = again.checkpoint_artifacts()

    def leaves(t):
        return ([x for k in sorted(t) for x in leaves(t[k])]
                if isinstance(t, dict) else [np.asarray(t)])
    for name, tree in saved.items():
        for a, b in zip(leaves(mine[name]), leaves(tree)):
            np.testing.assert_array_equal(a, b)


PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d4948445200000001000000010806000000"
    "1f15c4890000000d49444154789c6360000002000001e221bc330000000049454e44ae"
    "426082")


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        page = self.path.split("id=")[1].split("&")[0]
        if page == "2":
            self.send_error(404)
            return
        body, kind = (PNG, "image/png") if page == "1" else \
            (b"<html></html>", "text/html")
        self.send_response(200)
        self.send_header("Content-Type", kind)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture()
def server(monkeypatch):
    for var in ("http_proxy", "HTTP_PROXY", "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def test_scraper_downloads_records_and_resumes(server, tmp_path):
    out, state, errors = (tmp_path / "imgs", tmp_path / "state.json",
                          tmp_path / "errors.json")
    argv = [str(out), "--url-template",
            server + "/render?id={page_id}&width={width}&height={height}",
            "--max-id", "4", "--size", "8", "--sleep", "0",
            "--state", str(state), "--errors", str(errors),
            "--save-state-freq", "1"]
    scraper.main(argv)
    assert (out / "1.jpg").read_bytes() == PNG
    assert not (out / "2.jpg").exists() and not (out / "3.jpg").exists()
    assert json.loads(state.read_text()) == []
    assert sorted(json.loads(errors.read_text())) == [
        [2, "status 404"], [3, "not an image"]]

    # resume: the state's ids are fetched, the errors kept and extended
    (out / "1.jpg").unlink()
    state.write_text(json.dumps([1, 2]))
    errors.write_text(json.dumps([[9, "earlier"]]))
    scraper.main(argv)
    assert (out / "1.jpg").read_bytes() == PNG
    assert json.loads(state.read_text()) == []
    assert json.loads(errors.read_text()) == [[9, "earlier"],
                                              [2, "status 404"]]
