"""Job specification parsing.

Reference: ``jobspec2/parse.go:19`` (HCL2) and ``jobspec/`` (HCL1). This
build implements an HCL-subset parser (blocks, attributes, heredocs,
lists/maps, comments, ``${var}`` interpolation left verbatim) plus the JSON
job format the HTTP API accepts, both mapping onto ``structs.Job``.
"""

from .hcl import HCLParseError, parse_hcl
from .parse import api_to_job, job_to_api, parse_job

__all__ = [
    "HCLParseError",
    "parse_hcl",
    "parse_job",
    "api_to_job",
    "job_to_api",
]
