"""The port's API types: the Notebook CR, the SlicePool CR and the TPUQuota
CR."""

from .types import (API_VERSION, GROUP, KIND, SERVED_VERSIONS,
                    STORAGE_VERSION, convert_notebook, install_notebook_crd,
                    new_notebook, notebook_container, parse_version,
                    validate_notebook)

__all__ = ["API_VERSION", "GROUP", "KIND", "SERVED_VERSIONS",
           "STORAGE_VERSION", "convert_notebook", "install_notebook_crd",
           "new_notebook", "notebook_container", "parse_version",
           "validate_notebook"]
