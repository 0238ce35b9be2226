"""Environment/deployment checker (port of ``ttasr/cli/doctor.py``).

Replaces the reference's ``api/build.py`` (dependency audit, model-dir
validation, service launch probe — reference build.py:285-334,425-455).
This checks imports, the CUDA devices, whether the hand-written kernels
build and load (``nvcc`` and :func:`ttasr_torch.ops._build.load_library`),
model dirs and the native host library, and optionally launches or probes
the API server (``python -m ttasr_torch.api.app``).  A missing card or a
failed kernel build is reported as a failure: nothing switches to the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Dict

REQUIRED_MODULES = [
    "torch", "numpy", "aiohttp", "safetensors", "regex",
]
OPTIONAL_MODULES = ["scipy", "transformers", "tokenizers", "Levenshtein"]

MODEL_FILES = ("config.json",)
MODEL_WEIGHTS = ("model.safetensors", "pytorch_model.bin")


def check_modules() -> Dict[str, str]:
    status = {}
    for name in REQUIRED_MODULES:
        try:
            importlib.import_module(name)
            status[name] = "ok"
        except ImportError as exc:
            status[name] = f"MISSING ({exc})"
    for name in OPTIONAL_MODULES:
        try:
            importlib.import_module(name)
            status[name] = "ok (optional)"
        except ImportError:
            status[name] = "missing (optional)"
    return status


def _nvidia_smi() -> Dict[str, object]:
    """The cards' names and power limits as ``nvidia-smi`` prints them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return {"error": "nvidia-smi not found"}
    try:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}
    if proc.returncode != 0:
        return {"error": f"nvidia-smi exited {proc.returncode}: {proc.stderr.strip()}"}
    return {"cards": [line.strip() for line in proc.stdout.splitlines() if line.strip()]}


def check_devices() -> Dict[str, object]:
    """torch.cuda's view of the cards, and nvidia-smi's names and power
    limits.  Without CUDA the report says so (``cuda_available`` false)."""
    try:
        import torch
    except ImportError as exc:
        return {"error": str(exc)}
    if not torch.cuda.is_available():
        return {"platform": "none", "cuda_available": False, "device_count": 0,
                "devices": [], "error": "CUDA is not available"}
    count = torch.cuda.device_count()
    return {
        "platform": "gpu",
        "cuda_available": True,
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": _nvidia_smi(),
    }


def check_kernels() -> Dict[str, object]:
    """``nvcc`` found, and the kernel library built (or found built) and
    loaded, with the seconds it took; a failure is reported, not
    worked around."""
    from ttasr_torch.ops import _build

    out: Dict[str, object] = {}
    try:
        out["nvcc"] = _build._nvcc()
    except RuntimeError as exc:
        return {"nvcc": None, "loaded": False, "error": str(exc)}
    t0 = time.perf_counter()
    try:
        lib = _build.load_library()
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        out.update(loaded=False, error=str(exc)[-2000:])
        return out
    out.update(loaded=True, library=lib._name, entry_points=len(_build.ARGTYPES),
               seconds=round(time.perf_counter() - t0, 3))
    return out


def check_model_dir(path: str) -> Dict[str, object]:
    """Model directory validation (reference build.py:425-455 semantics,
    HF layout instead of CT2's model.bin)."""
    result: Dict[str, object] = {"path": path, "exists": os.path.isdir(path)}
    if not result["exists"]:
        return result
    missing = [f for f in MODEL_FILES if not os.path.exists(os.path.join(path, f))]
    has_weights = any(
        os.path.exists(os.path.join(path, w)) for w in MODEL_WEIGHTS
    ) or os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    result["missing_files"] = missing
    result["has_weights"] = has_weights
    result["has_tokenizer"] = os.path.exists(os.path.join(path, "tokenizer.json"))
    result["ok"] = not missing and has_weights
    return result


def check_native() -> Dict[str, object]:
    """The port's native host library (``ttasr_torch/native``): built by
    g++ from its copied source, or absent with the reason."""
    from ttasr_torch import native

    return native.status()


# module name -> pip distribution (reference build.py keeps such a map)
_PIP_NAMES = {
    "Levenshtein": "python-Levenshtein",
}
# per-package timeout + failure tolerance (reference build.py:155-226:
# slow/optional packages get longer timeouts and may fail without
# aborting the build)
_INSTALL_TIMEOUTS = {"torch": 600, "transformers": 600}
_TOLERATED = set(OPTIONAL_MODULES)


def install_missing(module_status: Dict[str, str]) -> Dict[str, object]:
    """pip-install missing modules (reference build.py:155-226).

    Explicitly opt-in (``--install-missing``): a deploy image bakes every
    dependency in, so this path is for external deployments.  Optional
    packages tolerate failure; required ones report it.
    """
    out: Dict[str, object] = {}
    for name, status in module_status.items():
        if not status.lower().startswith("missing"):
            continue
        pip_name = _PIP_NAMES.get(name, name)
        timeout = _INSTALL_TIMEOUTS.get(name, 300)
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "pip", "install", pip_name],
                capture_output=True, text=True, timeout=timeout,
            )
            if proc.returncode == 0:
                out[name] = "installed"
            elif name in _TOLERATED:
                out[name] = f"failed (tolerated): {proc.stderr[-200:]}"
            else:
                out[name] = f"FAILED: {proc.stderr[-200:]}"
        except Exception as exc:  # timeout, no pip, no network
            out[name] = (f"failed (tolerated): {exc}" if name in _TOLERATED
                         else f"FAILED: {exc}")
    return out


def launch_server(host: str = "127.0.0.1", port: int = 5000,
                  timeout_s: float = 120.0) -> Dict[str, object]:
    """Start the combined API app and poll until ready (reference
    build.py:503-849: port pre-check, subprocess launch, readiness
    probe).  The server keeps running after the doctor exits; the
    report carries its pid."""
    import socket
    import urllib.request

    # port pre-check (reference checks and warns, build.py:528-541)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.settimeout(1)
        if sock.connect_ex((host, port)) == 0:
            return {"launched": False,
                    "error": f"port {port} already in use"}

    env = dict(os.environ)
    env.setdefault("PYTHONIOENCODING", "utf-8")
    env["TTASR_API_HOST"] = host
    env["TTASR_API_PORT"] = str(port)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ttasr_torch.api.app"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    t0 = time.time()
    url = f"http://{host}:{port}/api/health"
    while time.time() - t0 < timeout_s:
        if proc.poll() is not None:
            return {"launched": False, "pid": proc.pid,
                    "error": f"server exited with {proc.returncode}"}
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                if resp.status == 200:
                    return {"launched": True, "pid": proc.pid,
                            "ready_in_s": round(time.time() - t0, 1),
                            "url": f"http://{host}:{port}"}
        except Exception:
            pass
        time.sleep(0.5)
    proc.terminate()
    return {"launched": False, "pid": proc.pid,
            "error": f"not ready within {timeout_s}s"}


async def probe_server(base_url: str) -> Dict[str, object]:
    """Hit the health endpoints of a running combined app
    (the reference's WS readiness probe, build.py:503-849)."""
    import aiohttp

    out: Dict[str, object] = {}
    async with aiohttp.ClientSession() as session:
        for name, path in (
            ("api", "/api/health"),
            ("auth", "/api/v1/health"),
            ("streaming", "/stream/health"),
        ):
            try:
                async with session.get(base_url + path, timeout=aiohttp.ClientTimeout(total=5)) as resp:
                    out[name] = {"status": resp.status, "body": await resp.json()}
            except Exception as exc:
                out[name] = {"error": str(exc)}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="ttasr_torch environment check")
    parser.add_argument("--model-dir", default=os.getenv("TTASR_MODEL_PATH", "models"))
    parser.add_argument("--probe", default=None,
                        help="base URL of a running API server to probe")
    parser.add_argument("--install-missing", action="store_true",
                        help="pip-install missing modules (reference "
                             "build.py behavior; off by default — a "
                             "deploy image bakes deps in)")
    parser.add_argument("--launch", action="store_true",
                        help="start the combined API app and wait for "
                             "readiness (reference build.py launch+probe)")
    parser.add_argument("--launch-port", type=int,
                        default=int(os.getenv("TTASR_API_PORT", "5000")))
    parser.add_argument("--launch-timeout", type=float, default=120.0)
    args = parser.parse_args(argv)

    report = {
        "python": sys.version.split()[0],
        "modules": check_modules(),
        "devices": check_devices(),
        "kernels": check_kernels(),
        "model_dir": check_model_dir(args.model_dir),
        "native": check_native(),
    }
    if args.install_missing:
        report["installs"] = install_missing(report["modules"])
        report["modules"] = check_modules()  # re-audit after installing
    if args.launch:
        report["launch"] = launch_server(port=args.launch_port,
                                         timeout_s=args.launch_timeout)
        if report["launch"].get("launched"):
            import asyncio

            report["server"] = asyncio.run(
                probe_server(report["launch"]["url"]))
    if args.probe:
        import asyncio

        report["server"] = asyncio.run(probe_server(args.probe))
    print(json.dumps(report, indent=2, ensure_ascii=False))
    return report


if __name__ == "__main__":
    main()
