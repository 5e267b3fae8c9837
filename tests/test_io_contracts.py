"""Byte-level output contract tests: the CSVs this framework writes must
parse exactly like the reference's (SURVEY.md §2.3), since downstream
tooling (including the reference's own plot scripts) reads them."""

import os

import numpy as np
import pandas as pd
import pytest

from mycelium_tpu.io.readers import read_mesh, read_mesh_dir
from mycelium_tpu.io.writers import (GROWTH_STATS_COLUMNS, dedup_nodes,
                                     export_geometry, write_fea_records,
                                     write_growth_stats, write_snapshot_csv,
                                     write_sweep_results)
from mycelium_tpu.native import meshio_native


def test_growth_stats_column_order(tmp_path):
    hist = [dict(hyphae=10, segments=20, active_tips=5, passive_tips=10,
                 anastomosed=5, branches=3, total_length_mm=1.25, step=0)]
    path = write_growth_stats(str(tmp_path), hist)
    df = pd.read_csv(path)
    # Python-variant order (mycelium_sim_2D.py:233-241): step LAST
    assert list(df.columns) == GROWTH_STATS_COLUMNS
    assert df.iloc[0]["total_length_mm"] == 1.25


def test_nodes_elements_schema(tmp_path):
    starts = np.array([[0, 0, 0], [1, 0, 0]], float)
    ends = np.array([[1, 0, 0], [2, 0, 0]], float)
    export_geometry(str(tmp_path), starts, ends)
    nodes = pd.read_csv(tmp_path / "nodes.csv")
    elems = pd.read_csv(tmp_path / "elements.csv")
    assert list(nodes.columns) == ["node_id", "x", "y", "z"]
    assert list(elems.columns) == ["elem_id", "n1", "n2"]
    assert len(nodes) == 3                 # shared endpoint deduped
    np.testing.assert_array_equal(elems[["n1", "n2"]].to_numpy(),
                                  [[0, 1], [1, 2]])


def test_dedup_matches_reference_rounding():
    # coordinates equal after 6-decimal rounding merge; beyond that differ
    starts = np.array([[0.1234567, 0, 0]])
    ends = np.array([[0.12345672, 0, 0]])      # same at 1e-6 resolution
    nodes, conn = dedup_nodes(starts, ends)
    assert len(nodes) == 1
    starts2 = np.array([[0.123456, 0, 0]])
    ends2 = np.array([[0.123458, 0, 0]])       # differs at 1e-6
    nodes2, _ = dedup_nodes(starts2, ends2)
    assert len(nodes2) == 2


def test_native_and_numpy_dedup_agree():
    rng = np.random.default_rng(0)
    pts = np.round(rng.normal(size=(500, 3)), 4)
    starts, ends = pts[:250], pts[250:]
    n_native, c_native = dedup_nodes(starts, ends)
    if not meshio_native.available():
        pytest.skip("native meshio not built")
    # numpy fallback path
    import mycelium_tpu.io.writers as w
    orig = meshio_native.dedup_nodes
    try:
        meshio_native.dedup_nodes = lambda *a, **k: None
        n_np, c_np = dedup_nodes(starts, ends)
    finally:
        meshio_native.dedup_nodes = orig
    np.testing.assert_allclose(n_native, n_np)
    np.testing.assert_array_equal(c_native, c_np)


def test_fea_records_schema(tmp_path):
    n_rec, n_elems, n_dof = 3, 4, 9
    rng = np.random.default_rng(1)
    write_fea_records(str(tmp_path),
                      rng.normal(size=(n_rec, n_elems)),
                      rng.random((n_rec, n_elems)) > 0.5,
                      rng.normal(size=(n_rec, n_dof)),
                      rng.normal(size=(n_rec, 2)))
    stress = pd.read_csv(tmp_path / "stress_record.csv")
    assert list(stress.columns) == [f"elem_{i}" for i in range(n_elems)] \
        + ["step"]
    assert stress["step"].tolist() == [1, 2, 3]     # 1-based steps
    active = pd.read_csv(tmp_path / "active_elements.csv")
    assert active.iloc[0, 0] in (True, False)       # True/False text
    disp = pd.read_csv(tmp_path / "node_displacements.csv")
    assert list(disp.columns) == [str(i) for i in range(n_dof)] + ["step"]
    fd = pd.read_csv(tmp_path / "force_displacement.csv")
    assert list(fd.columns) == ["total_displacement", "total_force"]


def test_snapshot_csv_contract(tmp_path):
    starts = np.array([[0, 0, 0], [1, 1, 0]], float)
    ends = np.array([[1, 0, 0], [2, 1, 0]], float)
    path = write_snapshot_csv(str(tmp_path), 7, starts, ends,
                              np.array([0.5, 0.25]))
    assert path.endswith("step_0007.csv")
    df = pd.read_csv(path)
    assert list(df.columns) == ["x1", "y1", "x2", "y2", "intensity"]


def test_sweep_results_schema(tmp_path):
    path = str(tmp_path / "runtime_results.csv")
    write_sweep_results(path, [(0, "cg", "block_jacobi", 0, 1.5)])
    df = pd.read_csv(path)
    assert list(df.columns) == ["step", "solver", "pc", "trial",
                                "runtime_ms", "pc_ref"]
    # the alias column maps our PC vocabulary onto the reference's
    # (fea_petsc_solverAndPC.cpp:223)
    assert df.iloc[0]["pc_ref"] == "sor"


def test_reader_skips_out_of_range_elements(tmp_path, ref_results):
    """The test_X_cpp_2 fixture references nodes that don't exist; the C++
    reference reader skips them (fea_petsc.cpp:241) and so do we."""
    d = os.path.join(ref_results, "test_X_cpp_2")
    coords, conn = read_mesh_dir(d)
    assert coords.shape[0] == 7
    assert (conn < 7).all()
    assert conn.shape[0] < 14       # some rows dropped


def test_reader_roundtrip_reference_mesh(ref_results):
    coords, conn = read_mesh_dir(os.path.join(ref_results, "test_I"))
    np.testing.assert_allclose(coords[:, 1], [0, 1, 2, 3])
    np.testing.assert_array_equal(conn, [[0, 1], [1, 2], [2, 3]])


def _mesh_for_graph_tests(n=400, seed=3):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import synthetic_mesh
    return synthetic_mesh(n, seed)


def test_native_path_cover_matches_python_oracle():
    if not meshio_native.available():
        pytest.skip("native meshio not built")
    from mycelium_tpu.fea.chain import greedy_path_cover
    coords, conn = _mesh_for_graph_tests()
    nn = coords.shape[0]
    p_native = meshio_native.path_cover(conn, nn)
    orig = meshio_native.path_cover
    try:
        meshio_native.path_cover = lambda *a: None
        p_py = greedy_path_cover(conn, nn)
    finally:
        meshio_native.path_cover = orig
    np.testing.assert_array_equal(p_native, p_py)
    # perm is a permutation
    assert np.array_equal(np.sort(p_native), np.arange(nn))


def test_native_spanning_forest_matches_python_oracle():
    if not meshio_native.available():
        pytest.skip("native meshio not built")
    from mycelium_tpu.fea.tree import spanning_forest
    coords, conn = _mesh_for_graph_tests(seed=11)
    nn = coords.shape[0]
    f_native = meshio_native.spanning_forest(conn, nn)
    orig = meshio_native.spanning_forest
    try:
        meshio_native.spanning_forest = lambda *a: None
        f_py = spanning_forest(conn, nn)
    finally:
        meshio_native.spanning_forest = orig
    np.testing.assert_array_equal(f_native, f_py)
    # a forest over one connected component has n-1 edges
    assert f_native.sum() <= nn - 1


# Header lines of the reference C++ binaries' CSVs (SURVEY.md §2.3,
# lines 129 and 137): the growth sim writes step FIRST
# (mycelium_sim_2D.cpp:559,571); the FEA writer groups displacement
# headers by component, node_i_x.. then _y.. then _z.. over DOF-ordered
# data (fea_petsc.cpp:477-505). test_I has 4 nodes.
CPP_GROWTH_STATS_HEADER = ("step,hyphae,segments,active_tips,passive_tips,"
                           "anastomosed,branches,total_length_mm")
CPP_TEST_I_DISP_HEADER = ",".join(
    [f"node_{i}_{ax}" for ax in "xyz" for i in range(4)] + ["step"])


def test_growth_stats_cpp_variant(tmp_path):
    """C++ growth sim puts step FIRST (mycelium_sim_2D.cpp:559,571) —
    header must byte-match the C++ binary's contract."""
    hist = [dict(hyphae=373, segments=623, active_tips=343,
                 passive_tips=250, anastomosed=30, branches=348,
                 total_length_mm=31.148600123, step=0)]
    path = write_growth_stats(str(tmp_path), hist, variant="cpp")
    lines = open(path).read().splitlines()
    assert lines[0] == CPP_GROWTH_STATS_HEADER
    assert lines[1] == "0,373,623,343,250,30,348,31.1486"


def test_fea_records_cpp_variant(tmp_path):
    """C++ FEA writers: 1/0 actives (fea_petsc.cpp:457-474) and the
    component-grouped node_i_x.. displacement header over DOF-ordered data
    (fea_petsc.cpp:477-505 — mislabeled in the reference, reproduced
    faithfully)."""
    n_rec, n_elems, n_nodes = 2, 3, 4       # test_I's shape
    rng = np.random.default_rng(1)
    write_fea_records(str(tmp_path),
                      rng.normal(size=(n_rec, n_elems)),
                      rng.random((n_rec, n_elems)) > 0.5,
                      rng.normal(size=(n_rec, 3 * n_nodes)),
                      rng.normal(size=(n_rec, 2)),
                      variant="cpp")
    active = open(tmp_path / "active_elements.csv").read().splitlines()
    assert set(active[1].split(",")[:-1]) <= {"0", "1"}
    disp_header = open(tmp_path / "node_displacements.csv"
                       ).readline().strip()
    assert disp_header == CPP_TEST_I_DISP_HEADER
