"""External LUT generators (counterpart of ``art_tpu/color/extclut.py``;
rtengine/extclut.{h,cc}), host code.

A JSON config (``{"ART-lut3d": {command, server, params, label}}``, the
format of ART's tools/extlut/*.json) names a child process that writes
a .cube 3D LUT for a set of parameter values. One-shot: the command runs
as ``command <params.json> <out.cube>`` for each request. Server
(``"server": true``): the child stays up; each request writes
``<params json>\n<outname>\n`` to its stdin and reads a ``Y``/``N``
status line, a message count and the messages (extclut.cc
SubprocessManager::process :215-280); `close` kills the child and
reaps it. Results are cached on disk under the temporary directory,
keyed by sha256(config path, mtime, params json) (get_cache_keys :127),
and load through `color/lut3d.py::load_lut3d`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shlex
import subprocess
import tempfile


def _strip_comments(text):
    from art_tpu_torch.raw.camconst import _strip_comments as strip

    return strip(text)


class ExternalLUT3D:
    def __init__(self, config_path):
        self.ok = False
        self.path = str(config_path)
        self.server = False
        self.command = []
        self.params = []  # descriptors: [name, label, ...spec]
        self.label = os.path.basename(self.path)
        self._proc = None
        try:
            with open(self.path) as f:
                cfg = json.loads(_strip_comments(f.read()))
        except (OSError, ValueError):
            return
        node = cfg.get("ART-lut3d")
        if not isinstance(node, dict) or "command" not in node:
            return
        self.command = shlex.split(node["command"])
        self.server = bool(node.get("server", False))
        self.params = list(node.get("params", []))
        self.label = node.get("label", self.label)
        self.workdir = os.path.dirname(self.path)
        self.ok = True

    # -- parameter handling -------------------------------------------------

    def default_values(self):
        out = {}
        for p in self.params:
            if len(p) >= 3:
                name = p[0]
                if isinstance(p[2], list):  # enum: [name, label, choices, i]
                    out[name] = int(p[3]) if len(p) > 3 else 0
                elif len(p) >= 5:  # [name, label, lo, hi, default, step]
                    out[name] = p[4]
                else:
                    out[name] = p[2]
        return out

    def params_json(self, values=None):
        v = self.default_values()
        if values:
            v.update({k: values[k] for k in values if k in v or True})
        return json.dumps(v, sort_keys=True)

    # -- LUT generation -----------------------------------------------------

    def _cache_path(self, pjson):
        base = os.path.join(tempfile.gettempdir(), "art_tpu_torch_extlut")
        os.makedirs(base, exist_ok=True)
        try:
            mt = os.path.getmtime(self.path)
        except OSError:
            mt = 0
        key = hashlib.sha256(
            f"{self.path}\n{mt}\n{pjson}".encode()).hexdigest()
        return os.path.join(base, key + ".cube")

    def generate(self, values=None, timeout=300):
        """Produce (and cache) the .cube for the given param values;
        returns the cube path or None."""
        if not self.ok:
            return None
        pjson = self.params_json(values)
        out = self._cache_path(pjson)
        if os.path.isfile(out) and os.path.getsize(out) > 0:
            return out
        if self.server:
            okflag = self._server_request(pjson, out, timeout)
        else:
            okflag = self._oneshot(pjson, out, timeout)
        return out if (okflag and os.path.isfile(out)) else None

    def _oneshot(self, pjson, out, timeout):
        fd, pfile = tempfile.mkstemp(suffix=".json",
                                     prefix="art_tpu_torch_extlut_p_")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(pjson)
            subprocess.run(self.command + [pfile, out],
                           cwd=self.workdir or None, check=True,
                           capture_output=True, timeout=timeout)
            return True
        except (subprocess.SubprocessError, OSError):
            return False
        finally:
            try:
                os.unlink(pfile)
            except OSError:
                pass

    def _server_request(self, pjson, out, timeout):
        import time

        if self._proc is None or self._proc.poll() is not None:
            try:
                self._proc = subprocess.Popen(
                    self.command, cwd=self.workdir or None,
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True, bufsize=1)
            except OSError:
                return False
        p = self._proc
        try:
            p.stdin.write(pjson + "\n" + out + "\n")
            p.stdin.flush()
            deadline = time.time() + timeout
            status = p.stdout.readline()
            if not status:
                return False
            status = status.strip()
            okflag = status.startswith("Y")
            n = 0
            rest = status[1:].strip()
            if rest.isdigit():
                n = int(rest)
            for _ in range(n):
                if time.time() > deadline:
                    return False
                p.stdout.readline()
            return okflag
        except (OSError, ValueError):
            return False

    def close(self):
        """Kill a server child that still runs, and reap it."""
        p, self._proc = self._proc, None
        if p is None:
            return
        if p.poll() is None:
            p.kill()
        for pipe in (p.stdin, p.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except OSError:
                pass
        p.wait()


_cache: dict = {}


def get_external_lut(config_path, values=None):
    """LUT table (N,N,N,3 float32) from an extclut JSON config, or None."""
    key = str(config_path)
    if key not in _cache:
        _cache[key] = ExternalLUT3D(config_path)
    ext = _cache[key]
    cube = ext.generate(values)
    if cube is None:
        return None
    from art_tpu_torch.color.lut3d import load_lut3d

    return load_lut3d(cube)
