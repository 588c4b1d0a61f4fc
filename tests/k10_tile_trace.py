"""Where a K10 diagonal tile's time goes, on the card (not a test; needs
nvcc and a CUDA device).

    python tests/k10_tile_trace.py [n]

Builds a copy of ``gapflow_torch/csrc/cholesky.cu`` in which thread 0 of
block 0 of ``diag_kernel`` and ``inv_kernel`` reads ``clock64()`` after
every block barrier, runs each kernel on the first tile of ``A A^T / n +
I`` (numpy seed n, default 2048) three times, and prints the last run's
cycles per phase between barriers, their sum, and the SM clock.
``diag_kernel``'s phases, in order: the load; D_0's factor; per
sub-column 0, 32, 64 the rows below, the update of the next diagonal
sub-block and the step (factor, inverse, updates and products); the last
step (D_3's inverse, the factor's and W's first stores); Z23; Z's last
rows; W's last rows.  ``inv_kernel``'s: the load, the 32 x 32 inverses,
the three levels of products and the store.  The build goes to a
temporary directory.
"""

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gapflow_torch.ops import _build  # noqa: E402

TIDS = "const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;"


def traced_source():
    """cholesky.cu with clock64() stamps after each barrier of the two
    tile kernels, and C entry points that launch one of them."""
    text = (ROOT / "gapflow_torch/csrc/cholesky.cu").read_text()
    text = text.replace("namespace {", "namespace {\n"
                        "__device__ long long g_ts[2][64];\n", 1)
    for slot, head in enumerate(("diag_kernel(float* M, int n, int x0, "
                                 "float* W) {",
                                 "inv_kernel(const float* L, int n, "
                                 "float* W) {")):
        i = text.index(head)
        j = text.index("\n}\n", i)
        stamp = (f"if (tid == 0 && blockIdx.x == 0) "
                 f"g_ts[{slot}][nts] = clock64(); ++nts;")
        body = text[i:j].replace(TIDS, f"{TIDS}\n    int nts = 0; {stamp}")
        body = body.replace("__syncthreads();", f"__syncthreads(); {stamp}")
        body += (f"\n    __syncthreads(); if (tid == 0 && blockIdx.x == 0) "
                 f"{{ g_ts[{slot}][nts] = clock64(); "
                 f"g_ts[{slot}][63] = nts + 1; }}")
        text = text[:i] + body + text[j:]
    return text + """
extern "C" int trace_read(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_ts, sizeof(g_ts));
}
extern "C" int trace_diag(float* M, int n, float* W) {
    int rc = tile_attr((const void*)diag_kernel);
    if (rc) return rc;
    diag_kernel<<<1, TILE_THREADS, TILE_SMEM>>>(M, n, 0, W);
    return (int)cudaDeviceSynchronize();
}
extern "C" int trace_inv(const float* L, int n, float* W) {
    int rc = tile_attr((const void*)inv_kernel);
    if (rc) return rc;
    inv_kernel<<<n / BLK, TILE_THREADS, TILE_SMEM>>>(L, n, W);
    return (int)cudaDeviceSynchronize();
}
"""


def main(n=2048):
    if not torch.cuda.is_available():
        raise SystemExit("k10_tile_trace: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "trace.cu"
        lib_path = pathlib.Path(tmp) / "trace.so"
        src.write_text(traced_source())
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-o", str(lib_path), str(src)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
        A = np.random.default_rng(n).standard_normal((n, n))
        M = torch.tensor(A @ A.T / n + np.eye(n), dtype=torch.float32,
                         device="cuda")
        W = torch.empty((n // 128, 128, 128), device="cuda")
        P = ctypes.c_void_p
        for _ in range(3):
            for rc in (lib.trace_diag(P(M.data_ptr()), n, P(W.data_ptr())),
                       lib.trace_inv(P(M.data_ptr()), n, P(W.data_ptr()))):
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
        ts = np.zeros((2, 64), np.int64)
        lib.trace_read(ts.ctypes.data_as(P))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                            "clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"card: {clock}")
    for slot, name in ((0, "diag_kernel"), (1, "inv_kernel")):
        t = ts[slot, :int(ts[slot, 63])]
        print(f"{name} n {n}: {int(t[-1] - t[0])} cycles = "
              + " + ".join(str(int(d)) for d in np.diff(t)))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
