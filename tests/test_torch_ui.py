"""PyTorch port: the debug HTML UI and its depictions, on the CPU.

The port's ``index_html`` and ``results_html`` must be byte-identical to the
JAX service's on the same libraries and queries, its ``_linkify`` must
escape hostile ids exactly as the JAX one does, and its copy of
``utils/depict`` must draw the same SVG. The UI's routes answer only with
``debug_ui`` set.
"""

import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

import gpusimilarity_tpu.serve.server as jserver
import gpusimilarity_tpu.utils.depict as jdepict
from gpusimilarity_tpu.models import DatabaseRegistry as JaxRegistry
from gpusimilarity_tpu.utils.fingerprints import smiles_to_fingerprint_bin
from gpusimilarity_tpu.utils.fsim import FingerprintData as JaxData
from gpusimilarity_tpu.utils.smiles import parse_smiles as jparse
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.serve import server as pserver
from gpusimilarity_tpu_torch.utils import depict as pdepict
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
from gpusimilarity_tpu_torch.utils.smiles import parse_smiles as pparse

from test_depict import CASES as DEPICT_CASES

CORPUS = [
    "CCO", "CCCO", "c1ccccc1", "c1ccncc1", "Cc1ccccc1", "CC(=O)O",
    "CC(=O)Oc1ccccc1C(=O)O", "C[NH+](C)CC(=O)N1c2ccccc2Sc2ccccc21",
    "c1ccc2ccccc2c1", "N#Cc1ccccc1", "OCC(O)CO", "Clc1ccccc1",
]
IDS = ["ZINC000001", "ZINC 2\" onmouseover=\"x", "CHEMBL3", "ZINC<b>4</b>",
       "plain-5", "ZINC6", "ZINC7&amp;", "ZINC8", "ZINC9", "ZINC10", "ZINC11",
       "ZINC12"]


def _fields(key=""):
    fps, smiles = [], []
    for s in CORPUS:
        fp, canon = smiles_to_fingerprint_bin(s)
        fps.append(np.frombuffer(fp, np.uint8))
        smiles.append(canon)
    return dict(dbkey=key, fingerprints=np.stack(fps), smiles=smiles,
                ids=[i.encode() for i in IDS])


@pytest.fixture(scope="module")
def services():
    preg, jreg = DatabaseRegistry(device="cpu"), JaxRegistry()
    for name, key in (("corpus", ""), ("keyed", "k")):
        preg.add(name, FingerprintData(**_fields(key)))
        jreg.add(name, JaxData(**_fields(key)))
    port = pserver.SearchService(preg, window_ms=1.0)
    ref = jserver.SearchService(jreg, window_ms=1.0)
    yield port, ref
    port.close()
    ref.close()


def test_index_html_matches_jax(services):
    port, ref = services
    assert port.index_html() == ref.index_html()
    assert 'value="corpus,keyed"' in port.index_html()


FORMS = {
    "smiles": {"smiles": "CCO", "return_count": "5", "dbnames": "corpus"},
    "aspirin_cutoff": {"smiles": "CC(=O)Oc1ccccc1C(=O)O", "return_count": "20",
                       "similarity_cutoff": "0.1", "dbnames": "corpus"},
    "merged_keys": {"smiles": "c1ccccc1", "return_count": "8",
                    "dbnames": "corpus,keyed", "dbkeys": ",k"},
    "fp_hex": {"fp_hex": smiles_to_fingerprint_bin("Clc1ccccc1")[0].hex(),
               "return_count": "4", "dbnames": "keyed", "dbkeys": "k"},
    "no_hits": {"smiles": "CCO", "dbnames": "keyed", "dbkeys": "wrong"},
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_results_html_matches_jax(services, name):
    port, ref = services
    payload = port.handle_search(dict(FORMS[name]))
    page = port.results_html(payload)
    assert page == ref.results_html(ref.handle_search(dict(FORMS[name])))
    assert page.count("<svg") >= len(payload["results"])
    assert "onmouseover=\"" not in page and "<b>" not in page


@pytest.mark.parametrize("cid", [
    "ZINC000123", "ZINC 9\" onerror=\"alert(1)", "ZINC'><script>x</script>",
    "ZINC/../a?b=c&d", "CHEMBL<i>1</i>", "zinc000001", "ZINC", "",
    "ZINCé ü", "ZINC%20x",
])
def test_linkify_escapes_hostile_ids_as_jax_does(cid):
    got = pserver._linkify(cid)
    assert got == jserver._linkify(cid)
    for bad in ('" o', "<script", "<i>"):
        assert bad not in got


@pytest.mark.parametrize("smi", DEPICT_CASES + ["[Na+].[Cl-]", "not_a_molecule(((("])
def test_smiles_to_svg_matches_jax(smi):
    assert pdepict.smiles_to_svg(smi) == jdepict.smiles_to_svg(smi)
    assert pdepict.smiles_to_svg(smi, size=160) == jdepict.smiles_to_svg(smi, size=160)


@pytest.mark.parametrize("smi", DEPICT_CASES)
def test_mol_to_svg_and_layout_match_jax(smi):
    assert pdepict.mol_to_svg(pparse(smi)) == jdepict.mol_to_svg(jparse(smi))
    assert pdepict.layout(pparse(smi)) == jdepict.layout(jparse(smi))
    assert pdepict.find_rings(pparse(smi)) == jdepict.find_rings(jparse(smi))


def _request(port, path, fields=None):
    data = None if fields is None else urllib.parse.urlencode(fields).encode()
    try:
        with urllib.request.urlopen(
            urllib.request.Request(f"http://localhost:{port}{path}", data=data),
            timeout=60,
        ) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.status, e.headers["Content-Type"], e.read().decode()


@pytest.mark.parametrize("debug_ui", [True, False], ids=["ui", "no_ui"])
def test_ui_routes_only_with_debug_ui(debug_ui):
    reg = DatabaseRegistry(device="cpu")
    reg.add("corpus", FingerprintData(**_fields()))
    srv = pserver.SimilarityServer(reg, port=0, debug_ui=debug_ui, window_ms=1.0)
    srv.start_background()
    try:
        form = {"smiles": "CCO", "dbnames": "corpus", "return_count": 3}
        for path in ("/", "/index.html"):
            status, ctype, body = _request(srv.port, path)
            if debug_ui:
                assert (status, ctype) == (200, "text/html")
                assert body == srv.service.index_html()
            else:
                assert status == 404 and json.loads(body) == {"error": "not found"}
        status, ctype, body = _request(srv.port, "/similarity_search", form)
        if debug_ui:
            assert (status, ctype) == (200, "text/html")
            assert "<svg" in body and "ZINC000001</a>" in body
        else:
            assert status == 404
        status, ctype, body = _request(srv.port, "/similarity_search_json", form)
        assert status == 200 and json.loads(body)["results"][0][:2] == ["ZINC000001", "CCO"]
    finally:
        srv.close()
