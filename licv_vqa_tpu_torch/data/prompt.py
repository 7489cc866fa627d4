"""Prompt templating.

Replaces the external ``lmm_icl_interface.LMMPromptManager`` (reference API
inferred from call sites: utils.py:33-39, vqa_dataset.py:104-123,
inference.py:273).  Template grammar from the reference's prompt configs
(config/prompt/*.yaml): column tokens like ``<Q>``/``<A>``/``<X>`` are filled
from a row dict; ``prompt_template`` renders full shots (with label +
optional separator), ``query_prompt_template`` renders the label-bearing
query without the trailing shot punctuation, and the query-without-label form
truncates the template at the label slot (producing e.g.
``"Question:q Short answer:"``).
"""

from __future__ import annotations

from typing import Mapping


class PromptManager:
    def __init__(
        self,
        prompt_template: str,
        column_token_map: Mapping[str, str],
        label_field: str,
        sep_token: str = "\n\n",
        query_prompt_template: str | None = None,
    ):
        self.prompt_template = prompt_template
        self.column_token_map = dict(column_token_map)
        self.label_field = label_field
        self.sep_token = sep_token
        self.query_prompt_template = query_prompt_template or prompt_template
        if label_field not in self.column_token_map:
            raise ValueError(
                f"label_field {label_field!r} missing from column_token_map"
            )

    def _fill(self, template: str, item: Mapping) -> str:
        out = template
        for column, token in self.column_token_map.items():
            if token in out:
                out = out.replace(token, str(item[column]))
        return out

    def gen_ice_text_with_label(self, item: Mapping, add_sep_token: bool = False) -> str:
        """Shot text with the label. With separator → the full shot template
        (e.g. ``"Question:q Short answer:a." + sep``); without → the query
        template (no trailing period), used for the student's query+label."""
        if add_sep_token:
            return self._fill(self.prompt_template, item) + self.sep_token
        return self._fill(self.query_prompt_template, item)

    def gen_query_text_without_label(self, item: Mapping) -> str:
        """Query text truncated at the label slot: ``"Question:q Short answer:"``."""
        label_token = self.column_token_map[self.label_field]
        template = self.query_prompt_template
        idx = template.find(label_token)
        if idx >= 0:
            template = template[:idx]
        return self._fill(template, item)
