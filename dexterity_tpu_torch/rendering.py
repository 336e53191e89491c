"""Host-side camera rendering for vision observables (port of
dexterity_tpu/rendering.py).

Physics runs on the model's device; pixels come from MuJoCo's native
offscreen renderer (EGL) on the host.  This is an explicit host boundary:
the physics state (qpos and mocap) crosses to the host once per control
step when a vision preset is enabled, and the images cross back to the
state's device.  The reference draws through dm_control's composer camera
observables (manipulation/shared/cameras.py:53-64 and the observations
VISION preset): the same host-side boundary.  Where the JAX package
bridges into jitted observation functions with jax.pure_callback, the
port calls the renderer directly.

The renderer works on the task's exported MJCF (mjcf/export.py, vendor
meshes included) with the camera configs inserted, and copies state
across by joint name, so it stays valid for any composed arena.  mujoco
is an optional dependency, imported only when a renderer is built.
"""

from __future__ import annotations

import concurrent.futures
import os
import xml.etree.ElementTree as ET
from typing import Sequence, Tuple

import numpy as np
import torch

from dexterity_tpu_torch.mjcf import export

# Must be set before mujoco loads an OpenGL platform library; EGL is the
# headless-friendly default.
os.environ.setdefault('MUJOCO_GL', 'egl')


def host_state(data) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(qpos (..., nq), mocap_pos (..., nmocap, 3), mocap_quat (..., nmocap,
  4)) of `data` as numpy arrays, brought to the host in one copy."""
  qpos = data.qpos
  batch, nq = qpos.shape[:-1], qpos.shape[-1]
  nm = data.mocap_pos.shape[-2]
  flat = torch.cat([qpos, data.mocap_pos.flatten(-2).to(qpos.dtype),
                    data.mocap_quat.flatten(-2).to(qpos.dtype)], -1)
  flat = flat.detach().cpu().numpy()
  return (flat[..., :nq],
          flat[..., nq:nq + 3 * nm].reshape(batch + (nm, 3)),
          flat[..., nq + 3 * nm:].reshape(batch + (nm, 4)))


class StateBridge:
  """Maps the port's physics state onto a host MuJoCo model of the task.

  Builds a MuJoCo model from the exported MJCF (vendor meshes included)
  and copies (qpos, mocap) across by joint name: robust to ordering
  differences, valid for any composed arena.  Shared by the offscreen
  camera renderer and the interactive viewer (manipulation/explore.py
  --interactive; the reference launches dm_control.viewer,
  explore.py:58-62).
  """

  def __init__(self, spec, model, camera_configs: Sequence = ()):
    """Args:
      spec: the task's ModelSpec (arena.spec).
      model: the compiled Model (its joint name and qpos address tables).
      camera_configs: CameraConfig sequence inserted into the worldbody.
    """
    import mujoco  # deferred: optional dependency

    xml = export.export_mjcf(spec, keep_visual=True, include_meshes=True)
    root = ET.fromstring(xml)
    wb = root.find('worldbody')
    existing = {c.get('name') for c in wb.findall('camera')}
    for cfg in camera_configs:
      if cfg.name in existing:
        continue
      ET.SubElement(
          wb, 'camera', name=cfg.name,
          pos=' '.join(f'{v:.12g}' for v in cfg.pos),
          xyaxes=' '.join(f'{v:.12g}' for v in cfg.xyaxes))
    # A top light so renders are not black.
    if wb.find('light') is None:
      ET.SubElement(wb, 'light', pos='0 0 2', dir='0 0 -1',
                    diffuse='0.8 0.8 0.8')
    self.mm = mujoco.MjModel.from_xml_string(
        ET.tostring(root, encoding='unicode'))
    self.md = mujoco.MjData(self.mm)
    self._mujoco = mujoco
    # State mapping by joint name: (ours_adr, theirs_adr, width).
    self._qpos_map = []
    for ji, name in enumerate(model.jnt_names):
      tj = mujoco.mj_name2id(self.mm, mujoco.mjtObj.mjOBJ_JOINT, name)
      if tj < 0:
        raise ValueError(f'joint {name!r} missing from exported model')
      w = {0: 7, 1: 4, 2: 1, 3: 1}[int(self.mm.jnt_type[tj])]
      self._qpos_map.append((int(model.jnt_qposadr[ji]),
                             int(self.mm.jnt_qposadr[tj]), w))
    self._nmocap = int(self.mm.nmocap)

  def scene_option(self):
    """MjvOption showing the right geom groups for this model."""
    opt = self._mujoco.MjvOption()
    if self.mm.nmesh > 0:
      # Vendor meshes are present (export include_meshes): show visual
      # groups 0-2, hide the fitted collision primitives (groups 3-5)
      # the meshes replace.
      opt.geomgroup[:3] = 1
      opt.geomgroup[3:] = 0
    else:
      # No mesh assets: the fitted primitives are the visuals (they sit
      # in groups viewers hide by default), so enable every group.
      opt.geomgroup[:] = 1
    return opt

  def copy_state(self, qpos: np.ndarray, mocap_pos: np.ndarray,
                 mocap_quat: np.ndarray) -> None:
    """Copies (nq,), (nmocap, 3), (nmocap, 4) numpy arrays into the MuJoCo
    data and refreshes derived quantities."""
    md = self.md
    for ours, theirs, w in self._qpos_map:
      md.qpos[theirs:theirs + w] = qpos[ours:ours + w]
    if self._nmocap:
      md.mocap_pos[:] = np.asarray(mocap_pos)[:self._nmocap]
      md.mocap_quat[:] = np.asarray(mocap_quat)[:self._nmocap]
    self._mujoco.mj_forward(self.mm, md)


class HostRenderer:
  """Renders camera images for states of a compiled task model."""

  def __init__(self, spec, model, camera_configs: Sequence,
               height: int = 84, width: int = 84):
    """Args:
      spec: the task's ModelSpec (arena.spec).
      model: the compiled Model (for joint name/address tables).
      camera_configs: CameraConfig sequence (shared/cameras.py presets).
      height/width: image size (CameraObservableSpec.height/width).
    """
    self._bridge = StateBridge(spec, model, camera_configs)
    self._mm = self._bridge.mm
    self._md = self._bridge.md
    self._mujoco = self._bridge._mujoco
    # The GL context is bound to the thread that made it (EGL): all GL
    # work, the context's creation included, runs on one worker thread.
    self._renderer = None
    self._executor = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix='dexterity-render')
    self._cameras = [cfg.name for cfg in camera_configs]
    self.height, self.width = height, width

  def render_state(self, qpos: np.ndarray, mocap_pos: np.ndarray,
                   mocap_quat: np.ndarray) -> np.ndarray:
    """(nq,), (nmocap, 3), (nmocap, 4) -> (ncam, h, w, 3) uint8."""
    if self._renderer is None:
      self._renderer = self._mujoco.Renderer(self._mm, self.height,
                                             self.width)
      self._scene_option = self._bridge.scene_option()
    self._bridge.copy_state(qpos, mocap_pos, mocap_quat)
    out = []
    for cam in self._cameras:
      self._renderer.update_scene(self._md, camera=cam,
                                  scene_option=self._scene_option)
      out.append(self._renderer.render().copy())
    return np.stack(out)

  def render_batch(self, qpos, mocap_pos, mocap_quat) -> np.ndarray:
    """Any leading batch shape -> (..., ncam, h, w, 3) uint8, rendered on
    the renderer's thread."""
    return self._executor.submit(
        self._render_batch_worker, qpos, mocap_pos, mocap_quat).result()

  def _render_batch_worker(self, qpos, mocap_pos, mocap_quat) -> np.ndarray:
    qpos = np.asarray(qpos)
    mocap_pos = np.asarray(mocap_pos)
    mocap_quat = np.asarray(mocap_quat)
    batch_shape = qpos.shape[:-1]
    flat_q = qpos.reshape((-1,) + qpos.shape[len(batch_shape):])
    n = flat_q.shape[0]
    if mocap_pos.size == 0:  # reshape(-1, 0, 3) is ambiguous for numpy
      flat_p = np.zeros((n, 0, 3))
      flat_r = np.zeros((n, 0, 4))
    else:
      flat_p = mocap_pos.reshape((-1,) + mocap_pos.shape[len(batch_shape):])
      flat_r = mocap_quat.reshape((-1,) + mocap_quat.shape[len(batch_shape):])
    imgs = np.stack([
        self.render_state(flat_q[i], flat_p[i], flat_r[i])
        for i in range(n)])
    return imgs.reshape(batch_shape + imgs.shape[1:])

  def close(self) -> None:
    """Frees the GL context on its own thread and stops the thread."""
    if self._renderer is not None:
      self._executor.submit(self._renderer.close).result()
      self._renderer = None
    self._executor.shutdown()


class CameraObservables:
  """Realizes CameraObservableSpec as pixel observables.

  The renderer is built at first use (after the task's model is
  compiled).  `as_dict(model, data)` brings the state to the host in one
  copy, renders every camera of every environment there, and returns the
  images on the state's device, so the observation dict stays a function
  of (model, data) for the caller.
  """

  def __init__(self, spec, camera_configs: Sequence, camera_spec):
    self._spec = spec
    self._configs = tuple(camera_configs)
    self._cam_spec = camera_spec
    self._renderer = None
    if getattr(camera_spec, 'depth', False) or getattr(
        camera_spec, 'segmentation', False):
      raise NotImplementedError(
          'depth/segmentation camera observables are not supported')

  @property
  def enabled(self) -> bool:
    return bool(getattr(self._cam_spec, 'enabled', False))

  def _get_renderer(self, model):
    if self._renderer is None:
      self._renderer = HostRenderer(
          self._spec, model, self._configs,
          height=self._cam_spec.height, width=self._cam_spec.width)
    return self._renderer

  def as_dict(self, model, data):
    """{camera name: (..., h, w, 3) uint8 on data.qpos.device}."""
    if not self.enabled:
      return {}
    renderer = self._get_renderer(model)
    imgs = renderer.render_batch(*host_state(data))
    imgs = torch.from_numpy(imgs).to(data.qpos.device)
    return {cfg.name: imgs[..., i, :, :, :]
            for i, cfg in enumerate(self._configs)}
