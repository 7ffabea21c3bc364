"""elementwise_share.train: share of the traced slice's device time in
operations that are neither matrix products (cuBLAS and the like) nor
the port's flash kernels (%)."""

from portbench.kernels import is_flash, is_gemm


def read(rec):
    sl = rec.get("slice")
    if rec.get("kind") != "train" or not rec.get("on_card") or not sl:
        return None
    total = sum(t for _, t in sl["ops"].values())
    rest = sum(t for name, (_, t) in sl["ops"].items()
               if not is_gemm(name) and not is_flash(name))
    return 100.0 * rest / total if total else None
