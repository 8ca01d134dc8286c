"""SMTP notifier. Disabled unless a host, a user and a recipient are
configured; it never raises."""

from __future__ import annotations

import logging
from typing import Optional


class Mailer:
    def __init__(self, host: Optional[str] = None, port: int = 587,
                 user: Optional[str] = None, password: Optional[str] = None,
                 to: Optional[str] = None):
        self.host, self.port = host, port
        self.user, self.password, self.to = user, password, to

    def send(self, subject: str, body: str) -> bool:
        """Send one message; False where unconfigured or on any failure."""
        if not (self.host and self.user and self.to):
            logging.getLogger("lwc_torch").debug(
                "mailer unconfigured; dropping message %r", subject)
            return False
        try:
            import smtplib
            from email.mime.text import MIMEText
            msg = MIMEText(body)
            msg["Subject"] = subject
            msg["From"] = self.user
            msg["To"] = self.to
            with smtplib.SMTP(self.host, self.port, timeout=10) as s:
                s.starttls()
                if self.password:
                    s.login(self.user, self.password)
                s.sendmail(self.user, [self.to], msg.as_string())
            return True
        except Exception:
            logging.getLogger("lwc_torch").exception("mailer send failed")
            return False
