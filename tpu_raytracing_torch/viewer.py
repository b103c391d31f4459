"""Interactive render viewer (parity: crates/viewer — wgpu/imgui app).

Counterpart of tpu_raytracing/viewer.py. The reference viewer runs the CPU
backend synchronously on a scene, streams radiance into a storage buffer,
tonemaps in a WGSL compute pass with exposure/gamma push constants, and
offers imgui controls (spp, depth, debug normals, pixel inspect)
(render_output_view.rs:13-97). This viewer keeps the same capabilities on a
matplotlib canvas:

- renders through the port's renderer on `--backend cuda` (the default; it
  raises without a card) or `cpu`, as the CLI does
- PROGRESSIVE refinement: samples accumulate in spp chunks and the canvas
  updates live after every chunk (render_output_view.rs:84-97 re-render
  loop; uses integrator.accumulate's on_chunk hook)
- exposure + gamma sliders re-tonemap without re-rendering
- 'n' toggles the normals AOV view, 'r' re-renders, 'q' quits
- clicking a pixel replays its sampler streams and prints the
  SinglePixelOutput diagnostics (viewer pixel-inspect equivalent)

Headless (no DISPLAY): renders once and writes a tonemapped PNG of the
beauty, <scene>_view.png, and of the wireframe, <scene>_wire.png.
matplotlib is imported only on the interactive path.

Usage: python -m tpu_raytracing_torch.viewer --scene-name sphere [-s N]
       [-d N] [--backend cuda|cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

log = logging.getLogger("tpu_raytracing_torch")


def _tonemap(rgb: np.ndarray, exposure: float, gamma: float) -> np.ndarray:
    x = np.clip(rgb * exposure, 0.0, 1.0)
    return x ** (1.0 / max(gamma, 1e-3))


def _wireframe_segments(scene, device="cuda") -> np.ndarray:
    """Raster-space wireframe of the scene's triangles, (N, 2, 2) float.

    SceneView role (crates/viewer/src/scene_view.rs — the reference draws
    a placeholder quad through its mvp pipeline; here the ACTUAL scene
    geometry is projected through the scene camera's world_to_raster).
    Instanced primitives are transformed by their instance matrices;
    segments behind the camera are dropped. The scene is compiled on
    `device` and its tables read back to the host.
    """
    from .device import compile_scene

    ds = compile_scene(scene, device)
    cam = scene.camera
    tris = []
    n_main = ds.meta.n_tris
    shade = ds.tri_shade.cpu().numpy()
    inst_xf = ds.inst_xf.cpu().numpy()
    if n_main:
        tris.append(shade[:n_main, 0:9].reshape(-1, 3, 3))
    for i, (_blas, _vbase, nt_b, shade_off) in enumerate(ds.meta.instances):
        rows = shade[shade_off:shade_off + nt_b, 0:9].reshape(-1, 3, 3)
        o2w = inst_xf[i, :16].reshape(4, 4)
        v = rows.reshape(-1, 3)
        vh = np.concatenate([v, np.ones((v.shape[0], 1), v.dtype)], axis=1)
        vw = (o2w @ vh.T).T
        tris.append((vw[:, :3] / vw[:, 3:4]).reshape(-1, 3, 3))
    if not tris:
        return np.zeros((0, 2, 2), np.float32)
    v = np.concatenate(tris).reshape(-1, 3)          # (3T, 3) world verts
    m = cam.world_to_raster.forward
    vh = np.concatenate([v, np.ones((v.shape[0], 1), v.dtype)], axis=1)
    ph = (m @ vh.T).T.reshape(-1, 3, 4)              # (T, 3, 4) clip space
    # per-edge near clip in homogeneous space (w > eps), THEN divide —
    # a ground plane extending behind the camera must still draw
    a = np.concatenate([ph[:, 0], ph[:, 1], ph[:, 2]], axis=0)
    b = np.concatenate([ph[:, 1], ph[:, 2], ph[:, 0]], axis=0)
    eps = 1e-4
    wa, wb = a[:, 3], b[:, 3]
    keep = (wa > eps) | (wb > eps)
    a, b, wa, wb = a[keep], b[keep], wa[keep], wb[keep]
    # interpolate the behind endpoint to the w=eps plane
    t = np.clip((eps - wa) / np.where(wb == wa, 1.0, wb - wa), 0.0, 1.0)
    clip_a = wa <= eps
    a = np.where(clip_a[:, None], a + t[:, None] * (b - a), a)
    t2 = np.clip((eps - wb) / np.where(wa == wb, 1.0, wa - wb), 0.0, 1.0)
    clip_b = wb <= eps
    b = np.where(clip_b[:, None], b + t2[:, None] * (a - b), b)
    pa = a[:, :2] / np.maximum(a[:, 3:4], eps)
    pb = b[:, :2] / np.maximum(b[:, 3:4], eps)
    return np.stack([pa, pb], axis=1).astype(np.float32)


def _rasterize_wireframe(edges: np.ndarray, width: int, height: int) -> np.ndarray:
    """Sample-based line draw for headless PNG output."""
    img = np.zeros((height, width, 3), np.float32)
    for a, b in edges:
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        ts = np.linspace(0.0, 1.0, min(n, 4 * max(width, height)))
        xs = np.clip((a[0] + (b[0] - a[0]) * ts).astype(int), 0, width - 1)
        ys = np.clip((a[1] + (b[1] - a[1]) * ts).astype(int), 0, height - 1)
        img[ys, xs] = 1.0
    return img


def _scene_info(scene, ds) -> str:
    """Scene statistics panel (DemoApplicationView role — the reference
    shows the imgui demo window; this surfaces actual scene data)."""
    cam = scene.camera
    lines = [
        f"camera: {type(cam.camera_type).__name__} "
        f"{cam.raster_width}x{cam.raster_height}",
        f"triangles: {ds.meta.n_tris} (+{sum(i[2] for i in ds.meta.instances)}"
        f" instanced)" if ds.meta.instances else
        f"triangles: {ds.meta.n_tris}",
        f"spheres: {ds.meta.n_spheres}",
        f"lights: {len(ds.meta.light_kinds)}",
        f"material kinds: {list(ds.meta.mat_kinds_present)}",
        f"instances: {len(ds.meta.instances)}",
    ]
    return "\n".join(lines)


def run_viewer(scene, settings, scene_name: str = "scene",
               device="cuda") -> None:
    from .integrator.accumulate import render_accumulated
    from .integrator.render import render, render_single_pixel
    from .settings import AovFlags

    settings.outputs = AovFlags.BEAUTY | AovFlags.NORMALS
    state = {"exposure": 1.0, "gamma": 2.2, "view": "beauty"}

    import copy

    def do_render(on_chunk=None):
        # normals AOV is a cheap single first-hit pass
        aov_settings = copy.copy(settings)
        aov_settings.outputs = AovFlags.NORMALS
        state["normals"] = (
            render(scene, aov_settings, device).normals + 1.0) * 0.5
        # beauty accumulates progressively in spp chunks
        beauty_settings = copy.copy(settings)
        beauty_settings.outputs = AovFlags.BEAUTY
        out = render_accumulated(
            scene, beauty_settings,
            spp_chunk=max(1, settings.samples_per_pixel // 8),
            on_chunk=on_chunk, device=device,
        )
        state["beauty"] = out.beauty

    headless = not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))
    if headless:
        from .device import compile_scene
        from .utils.png import save_png

        do_render()
        path = f"{scene_name}_view.png"
        save_png(path, state["beauty"], exposure=state["exposure"])
        log.info("headless: wrote %s", path)
        cam = scene.camera
        edges = _wireframe_segments(scene, device)
        wire = _rasterize_wireframe(
            edges, cam.raster_width, cam.raster_height
        )
        wpath = f"{scene_name}_wire.png"
        save_png(wpath, wire * 255.0, exposure=1.0)
        log.info("headless: wrote %s (%d wireframe edges)", wpath,
                 edges.shape[0])
        print(_scene_info(scene, compile_scene(scene, device)))
        return

    import matplotlib

    matplotlib.use("TkAgg")
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    fig, ax = plt.subplots(figsize=(10, 7))
    fig.subplots_adjust(bottom=0.18)
    fig.canvas.manager.set_window_title(
        f"tpu-raytracing-torch viewer — {scene_name}")
    cam = scene.camera
    placeholder = np.zeros((cam.raster_height, cam.raster_width, 3))
    im = ax.imshow(placeholder)
    title = ("click: pixel inspect · n: normals · w: wireframe · "
             "d: scene info · r: re-render · q: quit")
    ax.set_title(title)

    # SceneView wireframe (lazy) + scene-info overlay (demo-view role)
    from matplotlib.collections import LineCollection

    wire_lc = LineCollection([], colors="w", linewidths=0.5)
    wire_lc.set_visible(False)
    ax.add_collection(wire_lc)
    info_text = ax.text(
        0.02, 0.98, "", transform=ax.transAxes, va="top", ha="left",
        color="w", fontsize=9, family="monospace",
        bbox=dict(facecolor="black", alpha=0.6), visible=False,
    )

    ax_exp = fig.add_axes([0.15, 0.08, 0.6, 0.03])
    ax_gam = fig.add_axes([0.15, 0.03, 0.6, 0.03])
    s_exp = Slider(ax_exp, "exposure", 0.001, 1000.0, valinit=1.0)
    s_gam = Slider(ax_gam, "gamma", 1.0, 3.0, valinit=2.2)

    def redraw(_=None):
        view = state["view"]
        if view == "wire":
            if "wire_edges" not in state:
                state["wire_edges"] = _wireframe_segments(scene, device)
            wire_lc.set_segments(state["wire_edges"])
            wire_lc.set_visible(True)
            img = np.zeros_like(state["beauty"])
        else:
            wire_lc.set_visible(False)
            img = (
                state["normals"]
                if view == "normals"
                else _tonemap(state["beauty"], s_exp.val, s_gam.val)
            )
        im.set_data(np.clip(img, 0, 1))
        fig.canvas.draw_idle()

    s_exp.on_changed(redraw)
    s_gam.on_changed(redraw)

    def progressive(img, spp_done):
        """Live canvas update after each accumulated spp chunk."""
        state["beauty"] = img
        ax.set_title(f"{title}   [{spp_done}/{settings.samples_per_pixel} spp]")
        redraw()
        plt.pause(0.001)

    def on_key(event):
        if event.key == "n":
            state["view"] = "normals" if state["view"] != "normals" else "beauty"
            redraw()
        elif event.key == "w":
            state["view"] = "wire" if state["view"] != "wire" else "beauty"
            redraw()
        elif event.key == "d":
            if not info_text.get_visible():
                from .device import compile_scene

                info_text.set_text(
                    _scene_info(scene, compile_scene(scene, device)))
            info_text.set_visible(not info_text.get_visible())
            fig.canvas.draw_idle()
        elif event.key == "r":
            do_render(on_chunk=progressive)
            redraw()
        elif event.key == "q":
            plt.close(fig)

    def on_click(event):
        if event.inaxes is not ax or event.xdata is None:
            return
        x, y = int(event.xdata), int(event.ydata)
        for o in render_single_pixel(scene, settings, x, y, sample_count=1,
                                     device=device):
            print(
                f"pixel ({x}, {y}) sample {o.sample_index}: hit={o.hit} "
                f"uv=({o.uv[0]:.4f}, {o.uv[1]:.4f}) "
                f"normal=({o.normal[0]:.3f}, {o.normal[1]:.3f}, {o.normal[2]:.3f}) "
                f"radiance=({o.radiance[0]:.4f}, {o.radiance[1]:.4f}, "
                f"{o.radiance[2]:.4f})"
            )

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("button_press_event", on_click)
    fig.show()
    do_render(on_chunk=progressive)  # first render refines live
    redraw()
    plt.show()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(prog="tpu-raytracing-torch-viewer")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--scene-path")
    g.add_argument("--scene-name")
    p.add_argument("-s", "--spp", type=int, default=8)
    p.add_argument("-d", "--ray-depth", type=int, default=4)
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .settings import RaytracerSettings

    if args.scene_path:
        from .scene.loaders import scene_from_file

        scene = scene_from_file(args.scene_path)
        name = args.scene_path
        settings = RaytracerSettings()
    else:
        from .scene.test_scenes import get_test_scene

        ts = get_test_scene(args.scene_name)
        scene = ts.scene_func()
        settings = ts.settings_func()
        name = args.scene_name
    settings.samples_per_pixel = args.spp
    settings.max_ray_depth = args.ray_depth
    run_viewer(scene, settings, name, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
