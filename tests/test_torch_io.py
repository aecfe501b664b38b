"""The port's .mat loaders against the JAX package's, exactly: v5 files
written with scipy in both on-disk cube layouts, (H, W, B, 1) and
(1, B, H, W), a (1, 1, H, W) mask, and a v7.3 (HDF5) file written with h5py,
skipped where h5py is missing (the machine with the card has none)."""


import numpy as np
import pytest
import scipy.io
import torch

from lrs_pnp_dip_tpu.data import io as jio
from lrs_pnp_dip_tpu_torch.data import io as tio
from lrs_pnp_dip_tpu_torch.data import load_mask, load_mat_array, load_sample

torch.set_num_threads(1)

H, W, B = 6, 5, 4


@pytest.fixture()
def cubes():
    rng = np.random.default_rng(0)
    clean = rng.random((H, W, B)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.2).astype(np.float32)
    return clean, clean * mask[:, :, None], mask


def _assert_same_sample(ours, ref):
    for name in ("noisy", "mask", "clean"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    assert ours.name == ref.name


@pytest.mark.parametrize("layout", ["HWB1", "1BHW"])
def test_v5_files_load_as_jax_loads_them(tmp_path, cubes, layout):
    clean, noisy, mask = cubes

    def on_disk(cube):
        return cube[..., None] if layout == "HWB1" else cube.transpose(2, 0, 1)[None]

    paths = [str(tmp_path / f) for f in ("noisy.mat", "mask.mat", "clean.mat")]
    scipy.io.savemat(paths[0], {"masked_image": on_disk(noisy)})
    scipy.io.savemat(paths[1], {"msk": mask[None, None]})
    scipy.io.savemat(paths[2], {"clean_image": on_disk(clean).astype(np.float64)})
    ours = load_sample(*paths, name="t")
    _assert_same_sample(ours, jio.load_sample(*paths, name="t"))
    np.testing.assert_array_equal(ours.noisy, noisy)
    np.testing.assert_array_equal(ours.mask, mask)
    np.testing.assert_array_equal(load_mask(paths[1]), jio.load_mask(paths[1]))
    np.testing.assert_array_equal(load_mat_array(paths[0], "masked_image"),
                                  jio.load_mat_array(paths[0], "masked_image"))


def test_unrecognised_cube_shapes_raise():
    for arr in (np.zeros((2, 3, 4, 5), np.float32), np.zeros((4, 5), np.float32)):
        with pytest.raises(ValueError, match="unrecognised cube shape"):
            tio._to_canonical_cube(arr)
        with pytest.raises(ValueError, match="unrecognised cube shape"):
            jio._to_canonical_cube(arr)


def _write_v73(path, key, arr):
    """A MATLAB v7.3 file: HDF5 behind a 512-byte MATLAB header, the array
    stored with its dimensions reversed, as MATLAB writes it."""
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset(key, data=np.ascontiguousarray(arr.transpose(tuple(reversed(range(arr.ndim))))))
    header = b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Thu Jan  1 00:00:00 1970 HDF5 schema 1.00 ."
    header = header.ljust(116) + b"\0" * 8 + b"\x00\x02" + b"IM"
    with open(path, "r+b") as f:
        f.write(header.ljust(512, b"\0"))


def test_v73_files_load_as_jax_loads_them(tmp_path, cubes):
    clean, noisy, mask = cubes
    paths = [str(tmp_path / f) for f in ("noisy.mat", "mask.mat", "clean.mat")]
    _write_v73(paths[0], "masked_image", noisy[..., None])
    _write_v73(paths[1], "msk", mask[None, None])
    _write_v73(paths[2], "clean_image", clean[..., None])
    with pytest.raises(NotImplementedError):  # scipy refuses it: the h5py route is taken
        scipy.io.loadmat(paths[0])
    ours = load_sample(*paths)
    _assert_same_sample(ours, jio.load_sample(*paths))
    np.testing.assert_array_equal(ours.noisy, noisy)
    np.testing.assert_array_equal(ours.clean, clean)


def test_reference_tables_and_loaders_match(tmp_path, cubes):
    """The tables, and load_reference_pair on a directory laid out as the
    reference data is (its files written here)."""
    assert tio.REFERENCE_IMAGES == jio.REFERENCE_IMAGES
    assert tio.REFERENCE_MASKS == jio.REFERENCE_MASKS
    assert tio.REFERENCE_PAIRS == jio.REFERENCE_PAIRS
    assert not tio.reference_data_available(str(tmp_path))
    clean, noisy, mask = cubes
    noisy_fn, clean_fn = tio.REFERENCE_IMAGES["img2"]
    scipy.io.savemat(str(tmp_path / noisy_fn), {"masked_image": noisy.transpose(2, 0, 1)[None]})
    scipy.io.savemat(str(tmp_path / clean_fn), {"clean_image": clean[..., None]})
    for name in ("mask1", "mask2"):
        scipy.io.savemat(str(tmp_path / tio.REFERENCE_MASKS[name]), {"msk": mask[None, None]})
    assert tio.reference_data_available(str(tmp_path)) and jio.reference_data_available(str(tmp_path))
    ours = tio.load_reference_pair("img2", str(tmp_path))
    assert ours.name == "img2+mask2"
    _assert_same_sample(ours, jio.load_reference_pair("img2", str(tmp_path)))


def test_sample_sizes_match_jax():
    cube = np.zeros((5, 7, 3), np.float32)
    ours = tio.HsiSample(noisy=cube, mask=np.ones((5, 7), np.float32))
    ref = jio.HsiSample(noisy=cube, mask=np.ones((5, 7), np.float32))
    assert (ours.n_pixels, ours.n_bands) == (ref.n_pixels, ref.n_bands) == (35, 3)
