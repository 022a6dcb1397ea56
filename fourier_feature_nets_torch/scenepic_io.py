"""Optional scenepic visualizations.

Port of ``fourier_feature_nets_tpu/scenepic_io.py``: interactive 3D
inspections of a camera, a dataset's ray samples and a model's state,
built with ``scenepic`` when it is installed; without it each entry
point raises the JAX package's ``ImportError``. The model scene renders
through the port's raycaster (K1 where it is fused); every array handed
to scenepic is a host NumPy array.
"""

import numpy as np
import torch

__all__ = ["camera_to_scenepic", "dataset_to_scenepic",
           "model_to_scenepic"]


def _require_scenepic():
    try:
        import scenepic as sp
        return sp
    except ImportError as error:
        raise ImportError(
            "scenepic visualizations require the optional 'scenepic' "
            "package (pip install scenepic)") from error


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def camera_to_scenepic(camera, znear: float = 0.01, zfar: float = 100):
    """A :class:`~.cameras.CameraInfo` as a scenepic Camera."""
    sp = _require_scenepic()
    world_to_camera = sp.Transforms.gl_world_to_camera(camera.extrinsics)
    projection = sp.Transforms.gl_projection(camera.intrinsics,
                                             camera.resolution.width,
                                             camera.resolution.height,
                                             znear, zfar)
    return sp.Camera(world_to_camera, projection)


def _add_cameras(sp, scene, frustums, cameras, images, colors):
    """Each camera's frustum and image billboard; returns the
    billboards' meshes."""
    image_meshes = []
    for pixels, camera, color in zip(images, cameras, colors):
        sp_camera = camera_to_scenepic(camera)
        image = scene.create_image()
        image.from_numpy(pixels[..., :3])
        mesh = scene.create_mesh(layer_id="images",
                                 texture_id=image.image_id,
                                 double_sided=True)
        mesh.add_camera_image(sp_camera, depth=0.5)
        image_meshes.append(mesh)
        frustums.add_camera_frustum(sp_camera, color, depth=0.5,
                                    thickness=0.01)
    return image_meshes


def dataset_to_scenepic(dataset, num_rays_per_camera: int = 256):
    """A ray-sampling inspection scene: camera frusta, image billboards,
    the bounds cube, and each camera's sample points coloured by the
    ground truth (samples with alpha below 0.1 drawn black)."""
    sp = _require_scenepic()
    import matplotlib.pyplot as plt

    scene = sp.Scene()
    frustums = scene.create_mesh("frustums", layer_id="frustums")
    height = 800
    width = height * dataset.image_width // dataset.image_height
    canvas = scene.create_canvas_3d(width=width, height=height)
    canvas.shading = sp.Shading(sp.Colors.Gray)

    cameras = dataset.cameras
    colors = plt.get_cmap("jet")(np.linspace(0, 1, len(cameras)))[:, :3]
    image_meshes = _add_cameras(sp, scene, frustums, cameras,
                                dataset.images, colors)

    bounds_mesh = scene.create_mesh("bounds", layer_id="bounds")
    bounds_mesh.add_cube(sp.Colors.Blue,
                         transform=_host(dataset.sampler.bounds))

    for cam in range(dataset.num_cameras):
        pool = dataset.sampler._valid_for_camera(cam)
        sel = np.linspace(0, len(pool), num_rays_per_camera,
                          endpoint=False).astype(int)
        idx = torch.from_numpy(pool[sel]).to(dataset.device)
        samples = dataset.sampler.sample(idx, None)
        render = dataset.render(samples.rays)

        positions = _host(samples.positions).reshape(-1, 3)
        point_colors = np.repeat(_host(render.color), dataset.num_samples,
                                 axis=0)
        if render.alpha is not None:
            empty = np.repeat(_host(render.alpha) < 0.1,
                              dataset.num_samples)
        else:
            empty = np.zeros(len(positions), bool)

        mesh = scene.create_mesh(layer_id="samples")
        mesh.add_sphere(sp.Colors.White,
                        transform=sp.Transforms.scale(0.01))
        mesh.enable_instancing(positions=positions[~empty],
                               colors=point_colors[~empty])

        frame = canvas.create_frame()
        if empty.any():
            empty_mesh = scene.create_mesh(layer_id="empty samples")
            empty_mesh.add_sphere(sp.Colors.Black,
                                  transform=sp.Transforms.scale(0.01))
            empty_mesh.enable_instancing(positions=positions[empty])
            frame.add_mesh(empty_mesh)
        frame.camera = camera_to_scenepic(cameras[cam])
        frame.add_mesh(bounds_mesh)
        frame.add_mesh(mesh)
        frame.add_mesh(frustums)
        for image_mesh in image_meshes:
            frame.add_mesh(image_mesh)

    canvas.set_layer_settings({"bounds": {"opacity": 0.25},
                               "images": {"opacity": 0.5}})
    scene.framerate = 10
    return scene


def model_to_scenepic(raycaster, dataset, num_cameras: int = 10,
                      resolution: int = 50, num_samples: int = 64,
                      empty_threshold: float = 0.1):
    """The model's state as coloured sample spheres along
    ``resolution``^2 rays of each of ``num_cameras`` cameras, rendered by
    ``raycaster`` (``batched_render``: K1 where it is fused); samples of
    rays whose alpha is below ``empty_threshold`` are drawn black."""
    sp = _require_scenepic()
    import matplotlib.pyplot as plt

    dataset = dataset.sample_cameras(num_cameras, num_samples, False)
    scene = sp.Scene()
    frustums = scene.create_mesh("frustums", layer_id="frustums")
    canvas_res = dataset.cameras[0].resolution.scale_to_height(800)
    canvas = scene.create_canvas_3d(width=canvas_res.width,
                                    height=canvas_res.height)
    canvas.shading = sp.Shading(sp.Colors.Gray)

    colors = plt.get_cmap("jet")(
        np.linspace(0, 1, dataset.num_cameras))[:, :3]
    image_meshes = _add_cameras(sp, scene, frustums, dataset.cameras,
                                dataset.images, colors)

    sampler = dataset.sampler
    for cam in range(dataset.num_cameras):
        pool = sampler._valid_for_camera(cam)
        sel = np.linspace(0, len(pool), resolution * resolution,
                          endpoint=False).astype(int)
        rays = sampler.sample(torch.from_numpy(pool[sel]).to(
            sampler.device), None)
        pred = raycaster.batched_render(rays, 4096, False)

        positions = _host(rays.positions).reshape(-1, 3)
        color = np.repeat(np.clip(pred.color, 0, 1), num_samples, 0)
        empty = np.repeat(pred.alpha < empty_threshold, num_samples)

        mesh = scene.create_mesh()
        mesh.add_sphere(sp.Colors.White,
                        transform=sp.Transforms.scale(0.02))
        mesh.enable_instancing(positions=positions[~empty],
                               colors=color[~empty])
        empty_mesh = scene.create_mesh(layer_id="empty",
                                       shared_color=sp.Colors.Black)
        empty_mesh.add_sphere(transform=sp.Transforms.scale(0.02))
        empty_mesh.enable_instancing(positions=positions[empty])

        frame = canvas.create_frame()
        frame.camera = camera_to_scenepic(dataset.cameras[cam])
        frame.add_mesh(mesh)
        frame.add_mesh(empty_mesh)
        frame.add_mesh(frustums)
        for image_mesh in image_meshes:
            frame.add_mesh(image_mesh)

    scene.framerate = 10
    return scene
