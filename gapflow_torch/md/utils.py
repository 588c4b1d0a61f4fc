"""MD post-processing: wall-stress parsing and autocorrelation error bars.

Parity: reference GaPFlow/md/utils.py:27-218 (same stress_wall.dat layout:
5 columns = 1D [step, pL, tauxzL, pU, tauxzU], 7 columns = 2D adds
[tauyzL, tauyzU]; variance-of-mean via statistical inefficiency,
Chodera et al. JCTC 3 (2007)).
"""

import numpy as np


def _get_MPI_grid(Natoms, size, max_cpu, atoms_per_core=1000):
    """Heuristic Cartesian processor grid for a slab geometry."""
    ncpus = min(max_cpu, Natoms // atoms_per_core)

    ny = size // 2 + size % 2
    if max_cpu < ny ** 2:
        nx = ny = 1
    else:
        nx = ny

    nz = max(ncpus // (nx * ny), 1)
    return (nx, ny, nz)


def read_output_files(fname="stress_wall.dat", sf=1.):
    """Parse a wall-stress time series into the 13-entry (Y, Yerr) vectors."""
    md_data = np.loadtxt(fname) * sf

    Y = np.zeros((13,))
    Yerr = np.zeros((13,))

    cols = md_data.shape[1]
    pressL_t, tauxzL_t = md_data[:, 1], md_data[:, 2]
    pressU_t, tauxzU_t = md_data[:, 3], md_data[:, 4]

    Y[0] = (pressL_t.mean() + pressU_t.mean()) / 2.
    Y[5] = tauxzL_t.mean()
    Y[11] = tauxzU_t.mean()
    Yerr[0] = np.sqrt((variance_of_mean(pressL_t)
                       + variance_of_mean(pressU_t)) / 2.)
    Yerr[5] = np.sqrt(variance_of_mean(tauxzL_t))
    Yerr[11] = np.sqrt(variance_of_mean(tauxzU_t))

    if cols == 7:
        tauyzL_t, tauyzU_t = md_data[:, 5], md_data[:, 6]
        Y[4] = tauyzL_t.mean()
        Y[10] = tauyzU_t.mean()
        Yerr[4] = np.sqrt(variance_of_mean(tauyzL_t))
        Yerr[10] = np.sqrt(variance_of_mean(tauyzU_t))

    return Y, Yerr


def autocorr_func_1d(x):
    """Normalized autocorrelation of a 1D series.

    One Wiener-Khinchin FFT round trip on the mean-centered series
    (zero-padded to the next power of two above 2n-1 so the circular
    product is a linear correlation), debiased by the per-lag sample
    count and normalized to acf[0] = 1.
    """
    series = np.asarray(x, dtype=float)
    n = series.size
    centered = series - series.mean()

    nfft = 2 ** int(np.ceil(np.log2(2 * n - 1)))
    spec = np.fft.fft(centered, nfft)
    raw = np.fft.ifft(spec * np.conj(spec)).real[:n]
    acf = raw / (n - np.arange(n))
    return acf / acf[0]


def statistical_inefficiency(timeseries, mintime):
    """Decorrelation factor g >= 1 of a correlated time series.

    The integrated-autocorrelation estimator g = 1 + 2 sum_t (1 - t/n)
    acf(t) of Chodera et al., J. Chem. Theory Comput. 3 (2007), with
    the sum truncated at the first non-positive acf lag past
    ``mintime`` (past that point the acf estimate is noise).  The mean
    of the series then carries the information of n/g independent
    samples.
    """
    n = len(timeseries)
    acf = autocorr_func_1d(timeseries)
    lags = np.arange(n)
    cutoff = np.nonzero((acf <= 0) & (lags > mintime))[0][0]
    tapered = 2.0 * acf * (1.0 - lags / float(n))
    return max(1.0, 1.0 + tapered[1:cutoff].sum())


def variance_of_mean(timeseries, mintime=1):
    """Variance of the mean of a correlated time series: the naive
    var/n inflated by the decorrelation factor g."""
    g = statistical_inefficiency(timeseries, mintime)
    return np.var(timeseries) / len(timeseries) * g
