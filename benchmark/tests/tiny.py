"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test can hold: the same
files, with the configuration's size and the cell's tile replaced."""

from benchmark import spec

#: the Cholesky cell and the GEMM cell
POTRF, GEMM = "potrf_mp.n147456.nb6144", "gemm_bf16.n36864.nb12288"

#: the configuration's sizes at test size, by problem
SIZES = {"potrf": {"n": 96, "diagonal": 96},
         "gemm": {"m": 32, "n": 32, "k": 48}}


def tiny_cell(name: str, tile: int = 16) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, **SIZES[cell.problem])
    cell.traffic = dict(cell.traffic, tile=tile)
    return cell


def cells():
    return [w["name"] for w in spec.load_json(spec.MANIFEST)["workloads"]]
