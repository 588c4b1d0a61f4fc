"""Molecular dynamics driver base class with FAIR dataset packaging.

Each MD evaluation (one training point X -> observations Y, Yerr) is stored
as an immutable dataset: input files, raw output, and a README.yml with the
full provenance (owner, dates, parameters, X/Y/Yerr).

Parity: reference GaPFlow/md/base.py:43-239 (dtool packaging replaced by
:mod:`gapflow_torch.datasets`, same layout; a copy of the JAX
package's framework-free module).
"""

import abc
import os
import tempfile
from datetime import datetime, date, timedelta
from getpass import getuser

import yaml as _yaml

from .. import datasets as dt
from ..utils import bordered_text, echo, make_dumpable
from .runner import run_lammps, run_parallel, run_serial


class MolecularDynamics:
    """Abstract driver: build inputs, run the engine, read observations."""

    __metaclass__ = abc.ABCMeta

    name = "md"
    params: dict
    main_file: str
    num_worker: int
    is_mock: bool
    _dtool_basepath: str = None

    @property
    def _readme_template(self):
        template = os.path.join(os.path.dirname(__file__),
                                "readme_template.yml")
        if os.path.exists(template):
            with open(template) as fh:
                return fh.read()
        return ""
    _input_names = (["ρ", "jx", "jy", "h", "∂h/∂x", "∂h/∂y"]
                    + [f"extra_{i}" for i in range(10)])
    _ascii_art: str = r"""
   __ _  __ _ _ __   ___  _ __ ___   __| |
  / _` |/ _` | '_ \ / _ \| '_ ` _ \ / _` |
 | (_| | (_| | | | | (_) | | | | | | (_| |
  \__, |\__,_|_| |_|\___/|_| |_| |_|\__,_|
  |___/
"""

    @property
    def dtool_basepath(self):
        """Directory where run datasets are written: the Database's
        training path, else a fresh temporary directory (under TMPDIR)."""
        if self._dtool_basepath is None:
            self._dtool_basepath = tempfile.mkdtemp(prefix="gapflow_md_")
        return self._dtool_basepath

    @dtool_basepath.setter
    def dtool_basepath(self, name):
        self._dtool_basepath = name

    @abc.abstractmethod
    def build_input_files(self, dataset, location, X):
        """Write engine input files for training input X into the dataset."""
        raise NotImplementedError

    @abc.abstractmethod
    def read_output(self):
        """Parse engine output; return (Y, Yerr) 13-vectors."""
        raise NotImplementedError

    def _pretty_print(self, proto_datapath, X):
        text = ["Run next MD simulation in:", f"{proto_datapath}",
                self._ascii_art, "---"]
        for i, (Xi, name) in enumerate(zip(X, self._input_names)):
            text.append(f"Input {i + 1}: {float(Xi):+.3e}    ({name})")
        echo(bordered_text("\n".join(text)))

    def _write_readme(self, dataset_path, Xnew, Ynew, Yerrnew):
        metadata = _yaml.safe_load(self._readme_template) \
            if self._readme_template else {}
        if metadata is None:
            metadata = {}

        metadata["owners"] = [{"username": getuser()}]
        metadata["creation_date"] = date.today().isoformat()
        metadata["expiration_date"] = (
            date.today() + timedelta(days=3653)).isoformat()
        metadata["parameters"] = make_dumpable(self.params)
        metadata["X"] = make_dumpable(Xnew)
        metadata["Y"] = make_dumpable(Ynew)
        metadata["Yerr"] = make_dumpable(Yerrnew)

        with open(os.path.join(dataset_path, "README.yml"), "w") as fh:
            _yaml.safe_dump(metadata, fh)

    def _create_dataset(self, tag):
        ds_name = (f'{datetime.now().strftime("%Y%m%d_%H%M%S")}'
                   f'_{self.name}-{tag:03}')
        proto = dt.create_proto_dataset(name=ds_name,
                                        base_uri=self.dtool_basepath)
        return proto, proto.path

    def run(self, X, tag):
        """Run one MD evaluation for input X; package and return (Y, Yerr)."""
        dataset, location = self._create_dataset(tag)
        self.build_input_files(dataset, location, X)

        self._pretty_print(location, X)

        basedir = os.getcwd()
        os.chdir(os.path.join(location, "data"))
        try:
            if getattr(self, "engine", "native") == "lammps":
                # moltemplate-generated deck -> external LAMMPS world
                run_lammps(self.main_file, self.num_worker)
            elif self.num_worker > 1:
                run_parallel(self.main_file, self.num_worker)
            elif self.num_worker == 1:
                run_serial(self.main_file)

            Y, Ye = self.read_output()
        finally:
            os.chdir(basedir)

        self._write_readme(location, X, Y, Ye)
        dataset.freeze()

        return Y, Ye
