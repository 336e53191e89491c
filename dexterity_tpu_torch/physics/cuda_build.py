"""Builds and loads the port's CUDA kernel libraries.

Every `csrc/*.cu` source becomes its own plain-C shared library, compiled
with nvcc for sm_90a and loaded with ctypes.  The first call builds all of
them at once, one nvcc process per source, all started together, into
`build/dexterity_tpu_torch/<hash>/` at the repository root; the hash
covers every `.cu` file, so an edit to any source rebuilds the set.  Later
calls return the loaded libraries.  `launch` calls a library's entry on
a device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_CSRC = Path(__file__).resolve().parents[1] / 'csrc'
_BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / \
    'dexterity_tpu_torch'

# Build record: library paths, wall seconds of the parallel build (0 when
# every library was already built) and each nvcc's output (kept beside its
# library, so a later process reads it too).
build_info: Dict[str, object] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> Dict[str, Path]:
  """Library name -> source file, for every `.cu` file in csrc/."""
  return {p.stem: p for p in sorted(_CSRC.glob('*.cu'))}


def _nvcc() -> str:
  for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _nvcc_cmd(src: Path, out: Path, *flags: str) -> list:
  return [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
          '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', *flags,
          '-o', str(out), str(src)]


def _digest(srcs: Dict[str, Path]) -> str:
  h = hashlib.sha256()
  for name, path in srcs.items():
    h.update(name.encode())
    h.update(path.read_bytes())
  return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
  """Builds (where missing) and loads every kernel library; raises if any
  nvcc fails."""
  with _lock:
    if _libs:
      return _libs
    srcs = sources()
    out_dir = _BUILD_ROOT / _digest(srcs)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, logs = {}, {}
    for name, src in srcs.items():
      so = out_dir / f'libdex_{name}.so'
      if so.exists():
        continue
      tmp = so.with_suffix(f'.{os.getpid()}.tmp')
      procs[name] = (subprocess.Popen(_nvcc_cmd(src, tmp),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
      logs[name] = proc.communicate()[0]
      if proc.returncode != 0:
        failed.append(f'{name} (rc {proc.returncode}):\n{logs[name]}')
      else:
        so.with_suffix('.log').write_text(logs[name])
        os.replace(tmp, so)
    if failed:
      raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    libs = {name: ctypes.CDLL(str(out_dir / f'libdex_{name}.so'))
            for name in srcs}
    for name in srcs:
      if name not in logs:    # built earlier: its nvcc output lies beside it
        log = out_dir / f'libdex_{name}.log'
        logs[name] = log.read_text() if log.exists() else ''
    build_info.update(dir=str(out_dir), seconds=time.perf_counter() - t0,
                      built=sorted(procs), log=logs)
    _libs.update(libs)
    return _libs


def library(name: str) -> ctypes.CDLL:
  """The loaded library built from `csrc/<name>.cu`."""
  return build_all()[name]


def variant(name: str, define: str) -> ctypes.CDLL:
  """`csrc/<name>.cu` built with the macro `define` set, into a library
  of its own beside the set's (`libdex_<name>.<define>.so`): a
  measurement build of the same source, which leaves the kernels' own
  libraries as they are.  Raises if nvcc fails."""
  build_all()
  so = Path(build_info['dir']) / f'libdex_{name}.{define}.so'
  with _lock:
    if not so.exists():
      tmp = so.with_suffix(f'.{os.getpid()}.tmp')
      proc = subprocess.run(_nvcc_cmd(sources()[name], tmp, f'-D{define}'),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
      if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name} with {define} '
                           f'(rc {proc.returncode}):\n{proc.stdout}')
      os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def launch(fn, device: torch.device, *args) -> int:
  """Calls the C entry fn(*args, stream) with `device`'s current stream and
  returns its cudaError_t.  The stream is passed as its raw handle, without
  the Stream object torch.cuda.current_stream() builds around it (most of a
  wrapper's host time after the launch itself), and the device context is
  entered only when `device` is not the current device."""
  stream = torch._C._cuda_getCurrentRawStream(device.index)
  if device.index == torch.cuda.current_device():
    return fn(*args, stream)
  with torch.cuda.device(device):
    return fn(*args, stream)
