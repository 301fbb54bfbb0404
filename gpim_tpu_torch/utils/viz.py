"""
Matplotlib visualization helpers (host-side; counterpart of
``gpim_tpu/utils/viz.py``, numpy and matplotlib only).

Function-for-function parity with the plotting half of the reference's
gpim/gprutils.py:385-938: hyperparameter evolution (incl. spectral-mixture
components), raw hyperspectral data, 2D/3D reconstructions, exploration
episodes, inducing-point trajectories and BO query paths. Inputs follow the
same conventions (hyperparams dicts from the reconstructors, flattened
mean/sd arrays, lists of per-step arrays from boptimizer).

``import gpim_tpu_torch`` does not import this module: the CUDA machine the
port runs on may have no matplotlib. ``gpim_tpu_torch.utils`` imports it on
the first use of a ``plot_*`` name, which raises ImportError without
matplotlib.
"""

import copy
import os

import matplotlib.pyplot as plt
import numpy as np

__all__ = [
    "plot_kernel_hyperparams", "plot_mixture_hyperparams", "plot_raw_data",
    "plot_reconstructed_data2d", "plot_reconstructed_data3d",
    "plot_exploration_results", "plot_inducing_points",
    "plot_inducing_points_2d", "plot_inducing_points_3d", "plot_query_points",
]

_POS_COLORS = ['black', 'red', 'green', 'gray', 'orange', 'blue']


# ---------------------------------------------------------------------------
# Shared panel builders.
#
# The reference draws the same two panels - an energy-integrated image slice
# with position markers, and per-position spectroscopic curves with a shaded
# integration window - inline at four different call sites (gprutils.py
# plot_raw_data / plot_reconstructed_data3d x2 / plot_exploration_results).
# Here each panel is one helper and the public functions are thin
# compositions; the rendered output (figure sizes, titles, colors, alphas)
# is kept identical to the reference since that IS the parity contract.
# ---------------------------------------------------------------------------

def _zaxis(kwargs, n_channels):
    """Resolve the spectroscopic axis and its optional labeling from the
    shared z_vec/z_vec_label/z_vec_units kwargs."""
    z_vec = kwargs.get('z_vec')
    if z_vec is None:
        z_vec = np.arange(n_channels)
    return z_vec, kwargs.get('z_vec_label'), kwargs.get('z_vec_units')


def _label_response(ax, z_label, z_units):
    """Reference convention: axis labels appear only when BOTH the label and
    the units were supplied (gprutils.py:521-523 et al.)."""
    if z_label is not None and z_units is not None:
        ax.set_xlabel(z_label + ', ' + z_units)
        ax.set_ylabel('Response (arb. units)')


def _slice_image(ax, cube, s, spw, cmap, pos=None, colors=_POS_COLORS):
    """Image panel: the cube integrated over channels [s-spw, s+spw), with
    the probed positions scattered on top (row/col -> y/x)."""
    ax.imshow(np.sum(cube[:, :, s - spw:s + spw], axis=-1), cmap=cmap)
    if pos is not None:
        for p, col in zip(pos, colors):
            ax.scatter(p[1], p[0], c=col)


def _spectral_curves(ax, cube, pos, z_vec, s, spw, sd=None,
                     colors=_POS_COLORS, span_alpha=.15, ylim=(-0.1, 1.1)):
    """Curve panel: one spectrum per probed position (optionally with a
    2-sigma band), plus the shaded integration window."""
    for p, col in zip(pos, colors):
        y = cube[p[0], p[1], :]
        ax.plot(z_vec, y, c=col)
        if sd is not None:
            band = 2.0 * sd[p[0], p[1], :]
            ax.fill_between(z_vec, y - band, y + band, color=col, alpha=0.15)
    ax.axvspan(z_vec[s - spw], z_vec[s + spw], linestyle='--',
               alpha=span_alpha)
    if ylim is not None:
        ax.set_ylim(*ylim)


def _maybe_save(fig, save_fig, kwargs):
    """Reference save semantics (gprutils.py:556-560, 604-608): directory
    from 'savedir' (default 'Output'), filename stem from 'filepath'."""
    if not save_fig:
        return
    mdir = kwargs.get('savedir') or 'Output'
    os.makedirs(mdir, exist_ok=True)
    fpath = kwargs.get('filepath')
    name = (os.path.basename(os.path.splitext(fpath)[0])
            if fpath else 'reconstruction')
    fig.savefig(os.path.join(mdir, name))


def plot_kernel_hyperparams(hyperparams):
    """Evolution of lengthscale/noise(/variance) vs training iteration
    (reference gprutils.py:385-419)."""
    if "weights" in hyperparams.keys():
        plot_mixture_hyperparams(hyperparams)
        return
    has_var = 'variance' in hyperparams.keys() and \
        len(np.asarray(hyperparams['variance']).reshape(-1)) > 0
    if has_var:
        _, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(16, 4))
    else:
        _, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    lines = ax1.plot(np.asarray(hyperparams['lengthscale']), linewidth=3)
    ax1.set_title('lengthscale')
    ax1.set_xlabel('training iteration')
    ax1.set_ylabel('lengthscale (px)')
    ax1.legend(lines, ('dim 1', 'dim 2', 'dim 3'))
    ax2.plot(np.asarray(hyperparams['noise']), linewidth=3)
    ax2.set_yscale('log')
    ax2.set_title('noise')
    ax2.set_xlabel('training iteration')
    ax2.set_ylabel('noise (px)')
    plt.subplots_adjust(wspace=.5)
    if has_var:
        ax3.plot(np.asarray(hyperparams['variance']), linewidth=3)
        ax3.set_yscale('log')
        ax3.set_title('variance')
        ax3.set_xlabel('training iteration')
        ax3.set_ylabel('variance (px)')
    plt.show()


def plot_mixture_hyperparams(hyperparams):
    """Spectral-mixture component means/scales/weights evolution
    (reference gprutils.py:422-482; 2D data only)."""
    means = np.asarray(hyperparams["means"])
    scales = np.asarray(hyperparams["scales"])
    weights = np.asarray(hyperparams["weights"])
    noise = np.asarray(hyperparams["noise"])
    maxdim = hyperparams["maxdim"]
    if means.shape[-1] != 2:
        raise NotImplementedError(
            "Currently supports plotting only for 2D cases")
    print("Mixture (final) weights:")
    for i, w in enumerate(weights[-1]):
        print("Component {}: w = {}".format(
            i, np.float64(w).round(5)))
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(21, 6))
    q = means.shape[1]
    # hyperparams contract: means/scales are (iters, q, 1, d) - see
    # skreconstructor._assemble_hyperparams
    means = means.reshape(means.shape[0], q, -1)
    scales = scales.reshape(scales.shape[0], q, -1)
    for it in range(len(means)):
        lab1 = "x coordinate" if it == len(means) - 1 else None
        lab2 = "y coordinate" if it == len(means) - 1 else None
        ax1.scatter(np.tile(it, q), means[it, :, 0], s=18,
                    c=np.arange(q), cmap='jet', label=lab1)
        ax1.scatter(np.tile(it, q), means[it, :, 1], s=18, marker='x',
                    c=np.arange(q), cmap='jet', label=lab2)
        ax2.scatter(np.tile(it, q), scales[it, :, 0], s=18,
                    c=np.arange(q), cmap='jet', label=lab1)
        ax2.scatter(np.tile(it, q), scales[it, :, 1], s=18, marker='x',
                    c=np.arange(q), cmap='jet', label=lab2)
    ax1.set_xlabel("Iteration", fontsize=14)
    ax1.set_ylabel("Mixture mean/period (px)", fontsize=14)
    ax1.set_title("Mixtures mean (period)", fontsize=14)
    ax1.legend()
    ax2.set_xlabel("Iteration", fontsize=14)
    ax2.set_ylabel("Mixture scale (px)", fontsize=14)
    ax2.set_title("Mixtures scales", fontsize=14)
    ax2.legend()
    ax3.plot(noise, linewidth=3)
    ax3.set_ylabel("noise (px)", fontsize=14)
    ax3.set_xlabel("Iteration", fontsize=14)
    ax3.set_title("noise", fontsize=14)
    ax1.set_ylim(0, maxdim)
    ax2.set_ylim(0, maxdim)
    clrbar = np.linspace(1, q).reshape(-1, 1)
    ax_ = fig.add_axes([.36, -.12, .3, .8])
    img = plt.imshow(clrbar, cmap='jet')
    plt.gca().set_visible(False)
    cb = plt.colorbar(img, ax=ax_, orientation='horizontal')
    cb.set_label('Mixture component', fontsize=14, labelpad=10)
    plt.show()


def plot_raw_data(raw_data, slice_number, pos,
                  spec_window=2, norm=False, **kwargs):
    """2D energy-integrated slice + selected spectroscopic curves
    (output parity with reference gprutils.py:485-536)."""
    z_vec, z_label, z_units = _zaxis(kwargs, raw_data.shape[-1])
    _, (ax_img, ax_spec) = plt.subplots(1, 2, figsize=(10, 4.5))
    _slice_image(ax_img, raw_data, slice_number, spec_window,
                 kwargs.get('cmap', 'magma'), pos)
    _spectral_curves(ax_spec, raw_data, pos, z_vec, slice_number,
                     spec_window, span_alpha=.2,
                     ylim=(-0.1, 1.1) if norm else None)
    _label_response(ax_spec, z_label, z_units)
    ax_img.set_title('Grid spectroscopy data')
    ax_spec.set_title('Individual spectroscopic curves')
    plt.subplots_adjust(wspace=.3)
    plt.show()


def _input_title(sparsity):
    if sparsity:
        return ('Corrupted input data\n{}% of observations removed'
                .format(sparsity * 100))
    return 'Input data'


def plot_reconstructed_data2d(R, mean, save_fig=False, **kwargs):
    """Input vs GP-reconstructed 2D image (output parity with reference
    gprutils.py:539-584; the reference's duplicated set_title on ax1 is
    fixed - ax2 gets its own title)."""
    cmap = kwargs.get('cmap', 'nipy_spectral')
    fig, (ax_in, ax_gp) = plt.subplots(1, 2, figsize=(12, 6), dpi=100)
    ax_in.imshow(R, cmap=cmap, origin='lower')
    ax_gp.imshow(np.asarray(mean).reshape(R.shape), cmap=cmap,
                 origin='lower')
    ax_in.set_title(_input_title(kwargs.get('sparsity')))
    ax_gp.set_title('GP reconstruction')
    _maybe_save(fig, save_fig, kwargs)
    plt.show()


def plot_reconstructed_data3d(R, mean, sd, slice_number, pos,
                              spec_window=2, save_fig=False, **kwargs):
    """Input vs reconstruction for 3D cubes: integrated slices and per-point
    spectra with 2-sigma bands (output parity with reference
    gprutils.py:587-686). Each figure row is one (_slice_image,
    _spectral_curves) panel pair: input on top, reconstruction below."""
    cmap = kwargs.get('cmap', 'nipy_spectral')
    z_vec, z_label, z_units = _zaxis(kwargs, R.shape[-1])
    mean3 = np.asarray(mean).reshape(R.shape)
    sd3 = np.asarray(sd).reshape(R.shape)
    fig, ax = plt.subplots(2, 2, figsize=(14, 14))
    rows = [(R, None, _input_title(kwargs.get('sparsity'))),
            (mean3, sd3, 'GPR reconstruction')]
    for (cube, band, title), (ax_img, ax_spec) in zip(rows, ax):
        _slice_image(ax_img, cube, slice_number, spec_window, cmap, pos)
        _spectral_curves(ax_spec, cube, pos, z_vec, slice_number,
                         spec_window, sd=band)
        _label_response(ax_spec, z_label, z_units)
        ax_img.set_title(title)
        ax_spec.set_title(title)
    plt.subplots_adjust(hspace=.3)
    _maybe_save(fig, save_fig, kwargs)
    plt.show()


def plot_exploration_results(R_all, mean_all, sd_all, R_true,
                             episodes, slice_number, pos, dist_edge,
                             spec_window=2, mask_predictions=False,
                             **kwargs):
    """Observations / reconstructions / uncertainties at selected
    exploration episodes (reference gprutils.py:689-803)."""
    s, spw = slice_number, spec_window
    e1, e2, e3 = R_true.shape
    z_vec, z_label, z_units = _zaxis(kwargs, e3)
    _colors = ['black', 'red', 'green', 'blue', 'orange']
    if not np.isnan(R_true).any() or np.unique(R_true).any():
        _, ax = plt.subplots(1, 2, figsize=(7, 3), dpi=100)
        _slice_image(ax[0], R_true, s, spw, 'jet', pos, colors=_colors)
        _spectral_curves(ax[1], R_true, pos, z_vec, s, spw,
                         colors=_colors, span_alpha=.2)
        _label_response(ax[1], z_label, z_units)
        ax[0].set_title('Grid spectroscopy\n(ground truth)')
        ax[1].set_title('Individual spectroscopic curves\n(ground truth)')

    n = len(episodes) + 1
    fig = plt.figure(figsize=(20, 17), dpi=100)
    for i in range(1, n):
        Rcurr = np.asarray(R_all[episodes[i - 1]]).reshape(e1, e2, e3)
        Rtest = np.asarray(mean_all[episodes[i - 1]]).reshape(e1, e2, e3)
        R_sd = np.asarray(sd_all[episodes[i - 1]]).reshape(e1, e2, e3)

        ax = fig.add_subplot(4, n, i)
        ax.imshow(np.sum(Rcurr[:, :, s - spw:s + spw], axis=-1), cmap='jet')
        ax.set_title('Observations (step {})'.format(episodes[i - 1]))

        ax = fig.add_subplot(4, n, i + n)
        Rplot = copy.deepcopy(np.sum(Rtest[:, :, s - spw:s + spw], axis=-1))
        mask = np.zeros(Rplot.shape, bool)
        mask[dist_edge[0]:e1 - dist_edge[0],
             dist_edge[1]:e2 - dist_edge[1]] = True
        if mask_predictions:
            Rplot[~mask] = np.nan
        ax.imshow(Rplot, cmap='jet')
        for p, col in zip(pos, _colors):
            ax.scatter(p[1], p[0], c=col)
        ax.set_title('GPR reconstruction (step {})'.format(episodes[i - 1]))

        ax = fig.add_subplot(4, n, i + 2 * n)
        for p, col in zip(pos, _colors):
            ax.plot(z_vec, Rtest[p[0], p[1], :], c=col)
            ax.fill_between(
                z_vec,
                Rtest[p[0], p[1], :] - 2.0 * R_sd[p[0], p[1], :],
                Rtest[p[0], p[1], :] + 2.0 * R_sd[p[0], p[1], :],
                color=col, alpha=0.15)
            ax.axvspan(z_vec[s - spw], z_vec[s + spw],
                       linestyle='--', alpha=.15)
        ax.set_ylim(-0.1, 1.1)
        _label_response(ax, z_label, z_units)
        ax.set_title('GPR reconstruction (step {})'.format(episodes[i - 1]))

        ax = fig.add_subplot(4, n, i + 3 * n)
        sd_plot = np.sum(copy.deepcopy(R_sd), axis=-1)
        sd_plot[~mask] = np.nan
        ax.imshow(sd_plot, cmap='jet')
        ax.set_title('Integrated uncertainty (step {})'
                     .format(episodes[i - 1]))
    plt.subplots_adjust(hspace=.4, wspace=.3)
    plt.show()


def plot_inducing_points(hyperparams, **kwargs):
    """Dispatch 2D/3D inducing-point trajectory plots
    (reference gprutils.py:806-816)."""
    dims_ = np.asarray(hyperparams['inducing_points'][0]).shape[-1]
    if dims_ == 2:
        plot_inducing_points_2d(hyperparams, **kwargs)
    elif dims_ == 3:
        plot_inducing_points_3d(hyperparams, **kwargs)
    else:
        raise NotImplementedError('Supports only 2D and 3D datasets')


def _iteration_colorbar(fig, ax, n_steps, cmap, label):
    """Attach a 0..n_steps colorbar to ``ax`` via a ScalarMappable.

    The reference draws its colorbars by imshow-ing a hidden gradient strip
    into a hand-placed axes (gprutils.py:845-860, 896-911, 929-937); a
    mappable over an explicit Normalize is the direct way to express the
    same legend.
    """
    sm = plt.cm.ScalarMappable(cmap=cmap,
                               norm=plt.Normalize(vmin=0, vmax=n_steps))
    sm.set_array([])
    cb = fig.colorbar(sm, ax=ax, orientation='vertical')
    cb.set_label(label, fontsize=14, labelpad=10)
    return cb


def _ip_window(hyperparams, kwargs):
    pts = np.asarray(hyperparams['inducing_points'])
    plot_from = kwargs.get('plot_from') or 0
    plot_to = kwargs.get('plot_to') or len(pts)
    nth = kwargs.get('slice_step') or 1
    return pts[plot_from:plot_to], nth


def _plot_inducing_trajectories(ax, pts, nth, three_d):
    """Scatter every recorded inducing-point snapshot, one color per
    training iteration (output parity with gprutils.py:838-843, 888-893)."""
    colors = plt.cm.jet(np.linspace(0, 1, len(pts)))
    for snapshot, c in zip(pts, colors):
        cols = np.asarray(snapshot).T
        if three_d:
            ax.scatter(cols[0][::nth], cols[1][::nth], cols[2][::nth],
                       c=[c], s=.15)
        else:
            # snapshot rows are (row, col) grid indices; plot col as x
            ax.scatter(cols[1][::nth], cols[0][::nth], c=[c], s=.15)


def plot_inducing_points_2d(hyperparams, **kwargs):
    """2D inducing-point trajectories colored by iteration
    (reference gprutils.py:819-861)."""
    pts, nth = _ip_window(hyperparams, kwargs)
    fig, ax = plt.subplots(figsize=(10, 9))
    ax.set_xlabel('x coordinate (px)', fontsize=14)
    ax.set_ylabel('y coordinate (px)', fontsize=14)
    ax.set_title('Evolution of inducing points', fontsize=16)
    _plot_inducing_trajectories(ax, pts, nth, three_d=False)
    _iteration_colorbar(fig, ax, len(pts), 'jet', 'training iterations')
    plt.show()


def plot_inducing_points_3d(hyperparams, **kwargs):
    """3D inducing-point trajectories colored by iteration
    (reference gprutils.py:864-912)."""
    pts, nth = _ip_window(hyperparams, kwargs)
    fig = plt.figure(figsize=(11, 9))
    ax = fig.add_subplot(111, projection='3d')
    ax.view_init(20, 30)
    ax.set_xlabel('x coordinate (px)', fontsize=14)
    ax.set_ylabel('y coordinate (px)', fontsize=14)
    ax.set_zlabel('frequency (px)', fontsize=14)
    ax.set_title('Evolution of inducing points', fontsize=16)
    _plot_inducing_trajectories(ax, pts, nth, three_d=True)
    _iteration_colorbar(fig, ax, len(pts), 'jet', 'training iterations')
    plt.show()


def plot_query_points(inds_all, **kwargs):
    """BO exploration path over the 2D grid, colored by step order
    (output parity with reference gprutils.py:915-938)."""
    cmap = kwargs.get("cmap", "cool")
    plot_lines = kwargs.get("plot_lines", False)
    inds_all = np.asarray(inds_all)
    fig, ax = plt.subplots(figsize=(7, 6))
    rows, cols = inds_all[:, 0], inds_all[:, 1]
    if plot_lines:
        ax.plot(cols, rows, lw=.75, alpha=.6, zorder=1)
    ax.scatter(cols, rows, c=np.arange(len(inds_all)), cmap=cmap, zorder=2)
    _iteration_colorbar(fig, ax, len(inds_all), cmap, 'Exploration steps')
    plt.show()
