"""Built-in HTTP serving: a stdlib JSON endpoint around serve.Localizer,
the same surface as the JAX package's server (vslnet_tpu/server.py):

    POST /localize   body: {"vid": ..., "query": ..., "duration"?: seconds,
                            "top_k"?: k}
                     or a JSON LIST of such objects, batched through the
                     model batch_size rows at a time.
    GET  /healthz    {"status": "ok", <model/config info>}

Responses: {"vid", "query", "start", "end"} (seconds), or {"vid",
"query", "spans": [{"start", "end", "prob"}, ...]} with top_k.

Requests are served from a thread pool (ThreadingHTTPServer); the model
runs behind a lock, one batch at a time.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from vslnet_torch.config import resolve_device


def durations_from_dataset(dataset):
    """One pass over the splits: {vid: duration_seconds}. The duration is a
    property of the video, so split collisions are harmless."""
    durations = {}
    for split in ("train_set", "val_set", "test_set"):
        for rec in dataset.get(split) or []:
            durations[rec["vid"]] = rec["duration"]
    return durations


class RequestError(ValueError):
    """Client error -> HTTP 400 with {"error": ...}."""


def _parse_requests(body, visual_features, durations):
    """Validate a decoded /localize body (object or list of objects) into
    ([(vid, query, duration)], top_k). top_k must be uniform across a list
    (one decode per batch)."""
    items = body if isinstance(body, list) else [body]
    if not items:
        raise RequestError("empty request list")
    meta, top_ks = [], set()
    for i, rec in enumerate(items):
        if not isinstance(rec, dict):
            raise RequestError("request %d is not a JSON object" % i)
        try:
            vid, query = rec["vid"], rec["query"]
        except KeyError as e:
            raise RequestError(
                "request %d missing required field %s" % (i, e)
            )
        if vid not in visual_features:
            raise RequestError("no features for video %r" % (vid,))
        duration = rec.get("duration", durations.get(vid))
        if duration is None:
            raise RequestError(
                "video %r has no annotation record to read its duration "
                "from; pass a 'duration' field (seconds)" % (vid,)
            )
        top_ks.add(int(rec.get("top_k", 1)))
        meta.append((vid, query, float(duration)))
    if len(top_ks) > 1:
        raise RequestError(
            "top_k must be identical across a batched request, got %s"
            % sorted(top_ks)
        )
    k = top_ks.pop()
    if k < 1:
        raise RequestError("top_k must be >= 1, got %d" % k)
    return meta, (k if k > 1 else None)


def _result_obj(vid, query, res, top_k):
    if top_k:
        return {
            "vid": vid, "query": query,
            "spans": [
                {"start": round(s, 3), "end": round(e, 3),
                 "prob": round(p, 6)}
                for s, e, p in res
            ],
        }
    return {"vid": vid, "query": query,
            "start": round(res[0], 3), "end": round(res[1], 3)}


def make_server(localizer, visual_features, durations, host="127.0.0.1",
                port=8080, device=None):
    """Build (not start) the ThreadingHTTPServer; port=0 picks a free one
    (read it back from server.server_address). Call serve_forever() /
    shutdown() like any stdlib server. The localizer must run on `device`
    (default: the CUDA card)."""
    device = resolve_device(device)
    if localizer.device.type != device.type:
        raise ValueError("the localizer runs on %s, the server was asked for "
                         "%s" % (localizer.device, device))
    cfg = localizer.configs
    health = {
        "status": "ok",
        "task": cfg.task,
        "predictor": cfg.predictor,
        "max_pos_len": cfg.max_pos_len,
        "batch_size": cfg.batch_size,
        "videos": len(visual_features),
    }
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            data = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):  # quiet: no per-request stderr
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, health)
            else:
                self._reply(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path != "/localize":
                self._reply(404, {"error": "unknown path %s" % self.path})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError as e:
                    raise RequestError("invalid JSON body: %s" % e)
                meta, top_k = _parse_requests(
                    body, visual_features, durations
                )
                with lock:
                    results = localizer.localize_batch(
                        [(visual_features[v], d, q) for v, q, d in meta],
                        top_k=top_k,
                    )
                out = [
                    _result_obj(vid, query, res, top_k)
                    for (vid, query, _), res in zip(meta, results)
                ]
                self._reply(200, out if isinstance(body, list) else out[0])
            except RequestError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # don't kill the server thread
                self._reply(500, {"error": "%s: %s" % (type(e).__name__, e)})

    return ThreadingHTTPServer((host, port), Handler)


def run_server(localizer, visual_features, durations, host="127.0.0.1",
               port=8080, verbose=True, device=None):
    server = make_server(localizer, visual_features, durations, host, port,
                         device)
    if verbose:
        print(
            json.dumps({
                "serving": "http://%s:%d" % server.server_address[:2],
                "endpoints": ["POST /localize", "GET /healthz"],
            }),
            flush=True,
        )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server
